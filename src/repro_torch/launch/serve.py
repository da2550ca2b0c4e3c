"""Production serving launcher, built on the ``repro_torch.serve`` subsystem.

Counterpart of ``repro.launch.serve``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \\
        --requests 8 [--ckpt-dir /path] [--device cuda|cpu]

Drives a seeded request stream through a continuous-batching
``ModelServer`` (per-request cache slots, versioned params registry) and
prints the latency/throughput summary. ``--oneshot`` instead runs one
batched ``serve.generate`` call — the vlm family always takes that path,
since its decode needs a pre-warmed cross-attention cache the slot
lifecycle does not manage.

The model is the config's smoke variant with ``--smoke`` or on the CPU,
else the full config on the card. (The reference takes the smoke variant
whenever it sees one device, because its full configs are laid out for a
pod; one card is the port's target.)

``--ckpt-dir`` resolution is loud and layered:

  * federated round snapshots (``fedround_*.npz``) are authoritative — the
    newest round is restored params-only (``restore_federated_round`` with
    ``subset=True``) and the launcher prints which round and engine kind it
    is serving. A template/snapshot disagreement raises
    ``CheckpointMismatchError``; there is NO silent fallback to the legacy
    format when fedround files exist.
  * Otherwise the legacy flat ``ckpt_*.npz`` format is tried, and says so.

Either package's files are read: the port keeps params as a flat dict of
dotted names, the reference as the nested dict those names spell, and the
template takes the layout the snapshot's keypaths record.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.ckpt import (list_federated_rounds, read_federated_meta,
                              restore_checkpoint, restore_federated_round)
from repro_torch.configs import get_config, smoke_variant
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models import vlm as vlm_mod
from repro_torch.models.layers import flatten, nest
from repro_torch.serve import (ModelServer, TrafficConfig, TrafficSimulator,
                               VersionRegistry, generate)
from repro_torch.serve.traffic import GumbelSource


def _nested(keys) -> bool:
    """Whether recorded params keypaths are the reference's nested layout
    (``d:embed/d:tok_embed``) rather than the port's flat one
    (``d:embed.tok_embed``)."""
    return any("/" in k for k in keys)


def resolve_params(model: Any, ckpt_dir: Optional[str], device="cuda"):
    """(params, description, round) for ``--ckpt-dir``; see module docstring.

    ``round`` is the federated round the params came from, or -1 for a
    fresh init / legacy checkpoint. Params come back as the port's flat
    dict on ``device``.
    """
    dev = resolve_device(device)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    if not ckpt_dir:
        return params, "fresh init (no --ckpt-dir)", -1
    if list_federated_rounds(ckpt_dir):
        meta = read_federated_meta(ckpt_dir)
        like = nest(params, "") if _nested(meta["schema"]["trees"].get("params", {})) \
            else params
        # Params-only subset restore out of the full engine snapshot;
        # keypath/dtype/shape mismatches raise CheckpointMismatchError —
        # loudly, with no legacy fallback.
        trees, _, _ = restore_federated_round(
            ckpt_dir, likes={"params": like}, round_idx=meta["round"], subset=True)
        desc = f"federated round {meta['round']} snapshot ({meta['engine']} engine)"
        return flatten(trees["params"]), desc, int(meta["round"])
    try:
        restored, meta = restore_checkpoint(ckpt_dir, params)
    except KeyError:   # not the port's flat names: the reference's nested ones
        restored, meta = restore_checkpoint(ckpt_dir, nest(params, ""))
    return flatten(restored), f"legacy checkpoint {meta}", -1


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve from a federated round snapshot (fedround_*.npz, "
                         "params-only restore) or a legacy ckpt_*.npz directory")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of simulated requests to serve")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrival rate (requests per virtual unit)")
    ap.add_argument("--batch", type=int, default=4,
                    help="server slot width (continuous-batching lanes); "
                         "oneshot: the decode batch size")
    ap.add_argument("--tokens", type=int, default=16,
                    help="max output tokens per request (oneshot: exactly)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--oneshot", action="store_true",
                    help="one batched generate() call instead of the "
                         "traffic-driven server (vlm always does this)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke or dev.type == "cpu":
        cfg = smoke_variant(cfg)
    model = build_model(cfg)
    if not model.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only — no decode serving")

    params, desc, round_idx = resolve_params(model, args.ckpt_dir, device=dev)
    print(f"serving {cfg.name} from {desc}")

    prompt_len = (2, 6)
    if args.oneshot or cfg.family == "vlm":
        b, plen = args.batch, 4
        rng = np.random.default_rng(args.seed + 2)
        cache = model.init_cache(b, plen + args.tokens, device=dev)
        if cfg.family == "vlm":
            ve = torch.from_numpy(rng.standard_normal(
                (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)).to(dev)
            cache = vlm_mod.warm_cross_cache(cfg, params, cache, ve)
            print("vlm: cross-attention cache warmed (oneshot path)")
        prompt = rng.integers(0, cfg.vocab_size, size=(b, plen)).astype(np.int32)
        t0 = time.time()
        gen = generate(model, params, prompt, args.tokens, GumbelSource(args.seed + 2),
                       cache=cache)
        dt = time.time() - t0
        print(f"arch={cfg.name} batch={b}: {args.tokens} tokens in {dt:.2f}s "
              f"({b * args.tokens / dt:.1f} tok/s)")
        print(gen)
        return

    registry = VersionRegistry()
    registry.publish(params, round_idx=round_idx)
    max_len = prompt_len[1] + args.tokens
    server = ModelServer(model, registry, batch_width=args.batch, max_len=max_len,
                         device=dev)
    sim = TrafficSimulator(
        TrafficConfig(rate=args.rate, prompt_len=prompt_len,
                      output_len=(max(1, args.tokens // 2), args.tokens),
                      seed=args.seed, max_requests=args.requests),
        vocab=cfg.vocab_size)
    for req in sim.take(args.requests):
        server.submit(req, arrival_round=round_idx)
    records = server.pump()
    s = server.metrics.summary()
    print(f"arch={cfg.name} slots={args.batch}: served {s['requests']} "
          f"requests / {s['total_tokens']} tokens at "
          f"{s['decode_tok_per_s']:.1f} tok/s "
          f"(mean latency {s['total_ms_mean']:.1f} ms, "
          f"p95 {s['total_ms_p95']:.1f} ms)")
    v = registry.latest()
    print(f"served by version {v.version} (round {v.round})")
    for rec in records[:4]:
        print(f"  rid {rec.rid}: {rec.prompt_len}+{rec.output_len} tokens "
              f"-> {list(rec.tokens)[:8]}")


if __name__ == "__main__":
    main()
