"""The serving tier: versioned params registry and continuous-batching server.

Counterpart of ``repro.serve.server``. Three pieces:

  * ``VersionRegistry`` / ``PublishedVersion`` — an append-only registry of
    immutable published global-model versions. "Hot swap" is one list
    append of a reference to the params dict (no copy): readers bind
    ``registry.latest()`` once per admission wave and keep serving that
    object, so a publish can never tear an in-flight request. This relies
    on nothing writing into a published tensor afterwards: the engines
    rebind their params to new tensors each round and the aggregators
    write nothing in place (``tests/test_torch_serving.py`` holds a round-0
    version bitwise through later rounds).
  * ``generate()`` — the one canonical prefill+decode loop: teacher-forced
    prefill over the prompt, one position at a time through
    ``decode_step``, then sampled decode, with no feed after the last
    sample. It is the offline reference the served outputs must match
    bitwise.
  * ``ModelServer`` — a fixed-width continuous-microbatching decode server.
    Each of the ``batch_width`` slots holds one request's cache (the model's
    batch-1 cache stacked on a new leading slot axis) and its own position,
    and one ``torch.func.vmap(decode_step, in_dims=(None, 0, 0, 0))`` call
    ticks every slot per step. Requests are admitted into free slots as
    earlier ones complete — no barrier between requests — which is exactly
    continuous batching.

Sampling. Each emitted token is ``argmax(logits[:, 0, :vocab].float() +
g)``, with ``g`` that token's Gumbel row from the request's sampling source
(``traffic.GumbelSource``, or given rows): what ``jax.random.categorical``
computes from its key (``argmax(gumbel(key, shape, dtype) + logits)``, jax
0.9.0). Random draws come from outside, so ``generate`` and each server
slot read the same rows from the same source.

Hot-swap / staleness semantics: the server binds one ``PublishedVersion``
per admission *wave* (the span from an empty batch to the next empty
batch). While any request is in flight, newly admitted requests join the
bound — possibly stale — version; ``registry.latest()`` is re-read only
when the batch drains empty. Newer versions therefore become routable
atomically at wave boundaries, never mid-request, and every completed
request records exactly which version served it (``RequestRecord.version``
/ ``lag_rounds``). The per-round drain in ``publish.PublishHook`` makes a
wave of round t's traffic run entirely on the version published at round
t-1: serve v while v+1 aggregates.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serve.metrics import RequestRecord, ServingMetrics
from repro_torch.serve.traffic import DrawFn, Request


# ---------------------------------------------------------------------------
# Versioned params registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class PublishedVersion:
    """One immutable published global-model version.

    ``round`` is the training round whose aggregation produced ``params``
    (-1 for the pre-training init publish); ``step`` counts cumulative
    local optimizer steps; ``metric`` is the eval metric the publisher saw
    (NaN when it did not evaluate).
    """

    version: int
    round: int
    step: int
    params: Any = dataclasses.field(repr=False)
    metric: float = float("nan")


class VersionRegistry:
    """Append-only registry of ``PublishedVersion``s.

    Publishing is a single list append of a frozen record — O(1), no param
    copies, and atomic with respect to readers: ``latest()`` returns either
    the old or the new version object, never a torn state. Versions are
    numbered densely from 0 in publish order.
    """

    def __init__(self) -> None:
        self._versions: List[PublishedVersion] = []

    def __len__(self) -> int:
        return len(self._versions)

    @property
    def versions(self) -> Tuple[PublishedVersion, ...]:
        return tuple(self._versions)

    def publish(self, params: Any, *, round_idx: int, step: int = 0,
                metric: float = float("nan")) -> PublishedVersion:
        v = PublishedVersion(version=len(self._versions), round=int(round_idx),
                             step=int(step), params=params, metric=float(metric))
        self._versions.append(v)
        return v

    def latest(self) -> Optional[PublishedVersion]:
        return self._versions[-1] if self._versions else None

    def get(self, version: int) -> PublishedVersion:
        if not 0 <= version < len(self._versions):
            raise KeyError(f"no published version {version} "
                           f"(registry has {len(self._versions)})")
        return self._versions[version]


# ---------------------------------------------------------------------------
# The canonical one-shot decode loop
# ---------------------------------------------------------------------------


def params_device(params: Any) -> torch.device:
    """The device of a params dict (its first leaf's)."""
    return next(iter(params.values())).device


def sample(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Gumbel-max sampling over the last axis: argmax(logits (f32) + g),
    the first index among equal maxima (as ``jnp.argmax``)."""
    return torch.argmax(logits.to(torch.float32) + gumbel, dim=-1)


def slot_tick(model: Any):
    """``decode_step`` vmapped over a leading slot axis of the cache, tokens
    and positions, the params shared: one ``ModelServer`` tick."""
    return torch.func.vmap(model.decode_step, in_dims=(None, 0, 0, 0))


def generate(model: Any, params: Any, prompt: Any, num_tokens: int, draws: Any, *,
             cache: Any = None, slots: int = 0) -> np.ndarray:
    """Teacher-forced prefill over ``prompt`` (B, P), then ``num_tokens``
    sampled decode steps. Returns the generated ids as (B, num_tokens)
    int32.

    Token t is ``sample(logits[:, 0, :vocab], g_t)``, g_t the t-th (B,
    vocab) row block of ``draws.stream()`` (a ``GumbelSource``, a
    ``RowSource`` or any object whose ``stream()`` gives a ``DrawFn``) —
    the rows ``ModelServer`` reads per slot for a batch-1 request, which is
    what makes served-vs-offline outputs comparable bitwise. Runs on the
    params' device. ``cache`` overrides the fresh cache (the vlm launcher
    passes a cross-attention-warmed one); it must be sized for ``P +
    num_tokens`` positions.

    ``slots`` = W > 0 runs a batch-1 request as one slot of W-slot ticks
    (``slot_tick``; the other slots idle on zeros), the shapes a
    ``ModelServer`` of width W runs. A slot's logits do not depend on what
    the other slots hold, but they can depend on W: on the card cuBLAS picks
    its GEMM algorithm by row count, and a tick of W slots rounds some
    products differently from a batch-1 step (``chip_smoke.py`` phase 14a
    names them). With ``slots`` equal to the server's width the offline
    tokens are the served ones bit for bit on every device.
    """
    if not model.has_decode:
        raise ValueError(f"{model.cfg.name} is encoder-only — no decode path")
    dev = params_device(params)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32).to(dev)
    if prompt.dim() != 2 or prompt.shape[1] < 1:
        raise ValueError(f"prompt must be (batch, ≥1) token ids, got shape "
                         f"{tuple(prompt.shape)}")
    if num_tokens < 1:
        raise ValueError(f"num_tokens must be ≥ 1, got {num_tokens}")
    b, plen = prompt.shape
    if slots and b != 1:
        raise ValueError(f"slots={slots} runs one batch-1 request; the prompt has {b} rows")
    vocab = model.cfg.vocab_size
    if cache is None:
        cache = model.init_cache(b, plen + num_tokens, device=dev)
    step = model.decode_step
    if slots:
        # The request in slot 0 of ``slots``; the other slots tick on zeros.
        cache = {k: torch.cat([v[None], v.new_zeros((slots - 1, *v.shape))])
                 for k, v in cache.items()}
        tick = slot_tick(model)
        pad = torch.zeros((slots - 1, 1, 1), dtype=torch.int32, device=dev)
        zero = torch.zeros((slots - 1,), dtype=torch.int64, device=dev)

        def step(params, cache, tokens, pos):
            logits, cache = tick(params, cache, torch.cat([tokens[None], pad]),
                                 torch.cat([pos.reshape(1), zero]))
            return logits[0], cache

    draw = draws.stream()
    positions = torch.arange(plen + num_tokens, device=dev)
    out: List[torch.Tensor] = []
    with torch.no_grad():
        for i in range(plen):
            logits, cache = step(params, cache, prompt[:, i:i + 1], positions[i])
        for t in range(num_tokens):
            nxt = sample(logits[:, 0, :vocab], draw((b, vocab), dev))
            out.append(nxt)
            if t + 1 < num_tokens:  # the last sample needs no further feed
                logits, cache = step(params, cache, nxt[:, None].to(torch.int32),
                                     positions[plen + t])
    return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# Continuous-microbatching server
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Slot:
    """One occupied decode slot: request, bound version, progress, timing."""

    req: Request
    version: PublishedVersion
    draw: DrawFn
    arrival_round: int
    arrival_time: float
    t_submit: float                       # host perf_counter at submit
    t_admit: float
    t_prefill: Optional[float] = None     # set when the prompt is consumed
    pos: int = 0                          # tokens fed so far / next position
    generated: List[int] = dataclasses.field(default_factory=list)


class ModelServer:
    """Fixed-width continuous-batching decode server over a registry.

    ``batch_width`` slots; every ``step()`` runs ONE vmapped decode tick
    over all slots (each at its own position; free slots tick on zeros and
    their results are dropped), samples for slots past their prompt,
    retires completed requests, and admits pending ones into freed slots.
    ``pump()`` drains until idle. See the module docstring for the
    hot-swap/staleness contract. The caches live on ``device`` (``"cuda"``
    unless the caller asks for the CPU); the published params must be
    there too.

    VLM models are refused: their decode requires a per-request warmed
    cross-attention cache, which the slot lifecycle does not manage — use
    ``generate(cache=...)`` for one-shot vlm serving.
    """

    def __init__(self, model: Any, registry: VersionRegistry, *, batch_width: int = 4,
                 max_len: int = 64, metrics: Optional[ServingMetrics] = None,
                 device="cuda"):
        if not model.has_decode:
            raise ValueError(f"{model.cfg.name} is encoder-only — nothing to serve")
        if model.cfg.family == "vlm":
            raise NotImplementedError(
                "ModelServer does not manage per-request vlm cross-attention "
                "caches — serve vlm one-shot via repro_torch.serve.generate with a "
                "warm_cross_cache'd cache")
        if batch_width < 1:
            raise ValueError(f"batch_width must be ≥ 1, got {batch_width}")
        self.model = model
        self.registry = registry
        self.batch_width = int(batch_width)
        self.max_len = int(max_len)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.device = resolve_device(device)
        self._vocab = model.cfg.vocab_size
        self._step_fn = slot_tick(model)
        # Per-slot caches: the model's batch-1 cache stacked on a new
        # leading slot axis, so each slot decodes at its own position.
        self._caches = {name: leaf.expand(self.batch_width, *leaf.shape).clone()
                        for name, leaf in model.init_cache(1, self.max_len,
                                                           device=self.device).items()}
        self._slots: List[Optional[_Slot]] = [None] * self.batch_width
        # (request, arrival_round, arrival_time, host submit time)
        self._pending: Deque[Tuple[Request, int, float, float]] = deque()
        self._version: Optional[PublishedVersion] = None

    # -- introspection -----------------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def num_pending(self) -> int:
        return len(self._pending)

    @property
    def busy(self) -> bool:
        return bool(self._pending) or self.num_active > 0

    @property
    def serving_version(self) -> Optional[PublishedVersion]:
        """The version bound to the current admission wave (None if the
        server has not admitted anything yet)."""
        return self._version

    # -- request lifecycle -------------------------------------------------

    def submit(self, req: Request, *, arrival_round: int = -1,
               now: Optional[float] = None) -> None:
        """Queue a request (FIFO). Loud on impossible lengths — a request
        that cannot fit its cache must never be half-served."""
        total = req.prompt_len + req.output_len
        if req.prompt_len < 1 or req.output_len < 1:
            raise ValueError(f"request {req.rid}: prompt_len and output_len "
                             "must be ≥ 1")
        if total > self.max_len:
            raise ValueError(
                f"request {req.rid} needs {total} cache positions "
                f"(prompt {req.prompt_len} + output {req.output_len}) but "
                f"this server was built with max_len={self.max_len}")
        arr = float(now) if now is not None else float(req.arrival_time)
        self._pending.append((req, int(arrival_round), arr, time.perf_counter()))

    def _admit(self) -> None:
        for i in range(self.batch_width):
            if not self._pending:
                return
            if self._slots[i] is not None:
                continue
            if self.num_active == 0:
                # Wave boundary: this is the ONLY place the served version
                # can change — the atomic hot-swap point.
                latest = self.registry.latest()
                if latest is None:
                    raise RuntimeError(
                        "ModelServer cannot admit: the registry has no "
                        "published version — publish params first")
                self._version = latest
            req, arrival_round, arr_time, t_submit = self._pending.popleft()
            # Zero the slot's cache: attention caches are masked by position
            # anyway, but recurrent (mamba2/hybrid) slot state would leak
            # from the previous occupant without this. The server owns its
            # caches (each tick returns new ones), so this writes in place.
            for leaf in self._caches.values():
                leaf[i].zero_()
            self._slots[i] = _Slot(req=req, version=self._version,
                                   draw=req.draws.stream(), arrival_round=arrival_round,
                                   arrival_time=arr_time, t_submit=t_submit,
                                   t_admit=time.perf_counter())

    def tick(self, params: Any, tokens: np.ndarray, positions: np.ndarray) -> torch.Tensor:
        """One vmapped decode step of every slot: tokens (W,) and positions
        (W,) on the host. Advances the slots' caches; returns the logits
        (W, V_padded) on the device."""
        toks = torch.from_numpy(tokens.astype(np.int32).reshape(-1, 1, 1)).to(self.device)
        poss = torch.from_numpy(positions.astype(np.int64)).to(self.device)
        with torch.no_grad():
            logits, self._caches = self._step_fn(params, self._caches, toks, poss)
        return logits[:, 0, 0]

    def step(self) -> List[RequestRecord]:
        """Admit into free slots, run one decode tick, retire completions.

        Returns the requests that completed on this tick (also appended to
        ``self.metrics.records``). A tick feeds every active slot one token
        — the next prompt token while prefilling, its last sample while
        decoding — at that slot's own position.
        """
        self._admit()
        active = [i for i in range(self.batch_width) if self._slots[i] is not None]
        if not active:
            return []
        toks = np.zeros((self.batch_width,), np.int32)
        poss = np.zeros((self.batch_width,), np.int64)
        for i in active:
            s = self._slots[i]
            toks[i] = (int(s.req.prompt[s.pos]) if s.pos < s.req.prompt_len
                       else s.generated[-1])
            poss[i] = s.pos
        t0 = time.perf_counter()
        logits = self.tick(self._version.params, toks, poss)
        sampling = []
        for i in active:
            s = self._slots[i]
            s.pos += 1
            if s.pos < s.req.prompt_len:
                continue  # still prefilling — logits discarded
            sampling.append(i)
        done: List[RequestRecord] = []
        if sampling:
            # Slot i's row is its batch-1 logits (1, V): the chain generate()
            # runs for the request, sampled for every slot at once (the sum
            # and the row-wise argmax give each row's bits regardless).
            g = torch.cat([self._slots[i].draw((1, self._vocab), self.device)
                           for i in sampling])
            nxt = sample(logits[sampling, :self._vocab], g).tolist()   # waits for the tick
            t_now = time.perf_counter()
            for i, tok in zip(sampling, nxt):
                s = self._slots[i]
                if s.t_prefill is None:
                    s.t_prefill = t_now
                s.generated.append(int(tok))
                if len(s.generated) >= s.req.output_len:
                    done.append(self._finish(i))
        self.metrics.record_decode((time.perf_counter() - t0) * 1e3, len(sampling))
        return done

    def _finish(self, i: int) -> RequestRecord:
        s = self._slots[i]
        self._slots[i] = None
        t_done = time.perf_counter()
        rec = RequestRecord(
            rid=s.req.rid, arrival_time=s.arrival_time,
            arrival_round=s.arrival_round, prompt_len=s.req.prompt_len,
            output_len=s.req.output_len, tokens=tuple(s.generated),
            version=s.version.version, version_round=s.version.round,
            lag_rounds=s.arrival_round - s.version.round,
            queue_ms=(s.t_admit - s.t_submit) * 1e3,
            prefill_ms=(s.t_prefill - s.t_admit) * 1e3,
            decode_ms=(t_done - s.t_prefill) * 1e3)
        self.metrics.records.append(rec)
        return rec

    def pump(self) -> List[RequestRecord]:
        """Run until every pending and in-flight request has completed."""
        out: List[RequestRecord] = []
        while self.busy:
            out.extend(self.step())
        return out
