"""Deterministic inference-traffic simulator on the federation's clock.

Counterpart of ``repro.serve.traffic``. Requests arrive as a Poisson
process in *virtual time* — the same axis the async engines'
``fed.clock.VirtualClock`` measures training on — with seeded prompt
contents and prompt/output-length distributions, drawn from numpy's
``default_rng(seed)`` in the reference's order, so the request stream
(arrival times, lengths, prompts) is bitwise the reference's.

Generation is lazy and single-stream: ``schedule_until`` draws arrivals in
order until the first one past the window, stashes that overshoot, and
resumes from it next call. The draw order is therefore a function of the
seed alone — two simulators with equal configs produce identical request
sequences no matter how the callers slice time. Arrivals land on a
``VirtualClock.channel`` sub-queue, interleaving with training completions
on one clock while staying invisible to the training heap.

Random draws come from outside (torch cannot reproduce ``jax.random``'s
``fold_in`` and ``split``): where the reference gives each request a JAX
key, each ``Request`` here carries its sampling source (``draws``), the
standard Gumbel rows its decode adds to the logits, one row per emitted
token. By default that is ``GumbelSource(request_seed(cfg.seed, rid))``: a
``torch.Generator`` on the serving device seeded from (seed, rid), so
request i's draws do not depend on how arrivals were windowed. Tests hand
a ``RowSource`` of the reference's own Gumbel rows instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.fed.clock import ChannelQueue

_MASK64 = (1 << 64) - 1

# (shape, device) -> the next (shape) f32 Gumbel rows of one stream
DrawFn = Callable[[Tuple[int, ...], torch.device], torch.Tensor]


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def request_seed(seed: int, rid: int) -> int:
    """The seed of request ``rid``'s default draws under traffic seed
    ``seed``: splitmix64 of (seed mod 2³²)·2³² + (rid mod 2³²), its top 63
    bits (a non-negative ``torch.Generator`` seed)."""
    return _splitmix64(((seed & 0xFFFFFFFF) << 32) | (rid & 0xFFFFFFFF)) >> 1


@dataclasses.dataclass(frozen=True)
class GumbelSource:
    """A request's default sampling source: standard Gumbel rows from a
    ``torch.Generator`` seeded with ``seed``, on the device of the first
    row asked for (−log(−log u), u uniform in [tiny, 1), f32). Each
    ``stream()`` starts the sequence over, as each reuse of a JAX key does."""

    seed: int

    def stream(self) -> DrawFn:
        gen: List[torch.Generator] = []

        def draw(shape, device) -> torch.Tensor:
            device = torch.device(device)
            if not gen:
                gen.append(torch.Generator(device=device).manual_seed(self.seed))
            if gen[0].device != device:
                raise ValueError(f"this stream draws on {gen[0].device}, asked for {device}")
            u = torch.rand(shape, generator=gen[0], device=device)
            u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
            return -torch.log(-torch.log(u))

        return draw


@dataclasses.dataclass(frozen=True, eq=False)
class RowSource:
    """A sampling source that replays given rows, one per emitted token, in
    order (each an array of the shape asked for)."""

    rows: Sequence[np.ndarray]

    def stream(self) -> DrawFn:
        it = iter(self.rows)

        def draw(shape, device) -> torch.Tensor:
            row = torch.from_numpy(np.array(next(it), np.float32))
            if tuple(row.shape) != tuple(shape):
                raise ValueError(f"replayed row of shape {tuple(row.shape)}, asked for "
                                 f"{tuple(shape)}")
            return row.to(device)

        return draw


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Poisson request stream parameters.

    ``rate`` is mean arrivals per virtual time unit — under the sync round
    policy one round costs "1", so it reads as requests-per-round there.
    Length bounds are inclusive. ``max_requests`` caps the stream (None =
    unbounded); the serving launcher uses it for fixed-size runs.
    """

    rate: float = 4.0
    prompt_len: Tuple[int, int] = (2, 6)
    output_len: Tuple[int, int] = (4, 8)
    seed: int = 0
    max_requests: Optional[int] = None

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"traffic rate must be > 0, got {self.rate}")
        for name, (lo, hi) in (("prompt_len", self.prompt_len),
                               ("output_len", self.output_len)):
            if lo < 1 or hi < lo:
                raise ValueError(f"{name} bounds must satisfy 1 ≤ lo ≤ hi, "
                                 f"got ({lo}, {hi})")


@dataclasses.dataclass(frozen=True, eq=False)
class Request:
    """One inference request: seeded prompt and sampling source, stamped
    with its virtual arrival time."""

    rid: int
    arrival_time: float
    prompt: np.ndarray       # (prompt_len,) int32 token ids
    output_len: int
    draws: GumbelSource | RowSource   # the decode's Gumbel rows (``stream()``)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


class TrafficSimulator:
    """Seeded lazy Poisson arrival generator over a token vocabulary."""

    def __init__(self, cfg: TrafficConfig, vocab: int):
        if vocab < 1:
            raise ValueError(f"traffic needs a token vocab ≥ 1, got {vocab} "
                             "(is the served model an LM family?)")
        self.cfg = cfg
        self.vocab = int(vocab)
        self._rng = np.random.default_rng(cfg.seed)
        self._t = 0.0
        self._count = 0
        self._ahead: Optional[Request] = None  # overshoot from last window

    def _draw(self) -> Optional[Request]:
        cfg = self.cfg
        if cfg.max_requests is not None and self._count >= cfg.max_requests:
            return None
        self._t += float(self._rng.exponential(1.0 / cfg.rate))
        plen = int(self._rng.integers(cfg.prompt_len[0], cfg.prompt_len[1] + 1))
        olen = int(self._rng.integers(cfg.output_len[0], cfg.output_len[1] + 1))
        prompt = self._rng.integers(0, self.vocab, size=plen).astype(np.int32)
        req = Request(rid=self._count, arrival_time=self._t, prompt=prompt,
                      output_len=olen,
                      draws=GumbelSource(request_seed(cfg.seed, self._count)))
        self._count += 1
        return req

    def take(self, n: int) -> List[Request]:
        """The next ``n`` requests regardless of arrival time (offline use:
        the serving launcher driving a fixed-size run)."""
        out: List[Request] = []
        while len(out) < n:
            req = self._ahead or self._draw()
            self._ahead = None
            if req is None:
                break
            out.append(req)
        return out

    def schedule_until(self, queue: ChannelQueue, until: float) -> int:
        """Schedule every arrival with time ≤ ``until`` on ``queue``.

        Returns the number scheduled. The first arrival past the window is
        buffered, not dropped — successive windows tile the stream exactly.
        """
        n = 0
        while True:
            req = self._ahead or self._draw()
            if req is None:
                break
            if req.arrival_time > until:
                self._ahead = req
                break
            self._ahead = None
            queue.schedule_at(req.arrival_time, tag=req.rid, payload=req)
            n += 1
        return n
