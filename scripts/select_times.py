#!/usr/bin/env python3
"""Time K2 and the fused and sharded selects of one source tree on one card.

    python3 scripts/select_times.py [--src DIR] [--tag NAME]

``--src`` is a tree's ``src`` directory (default: this checkout's), so that
two commits can be timed in turns within one call on one card (the other
one unpacked with ``git archive``). Prints the card's name and power limit,
then one JSON line per measurement:

  * K2 (``score_select``) alone at the flat path's K = 12, m = 6 (f32) and
    at K = 2^20, m = 1024 (f32 and bf16), on random rows and Gumbel noise;
  * the fused select (``ops.heterosel_topm``, K1 + K2) and K8
    (``ops.heterosel_topm_sharded`` on a one-rank NCCL group made here) at
    Table 8's K = 10^3 and 10^6, m = K/1000, bf16 state, round 7, with K8's
    collective calls per call counted.

Each: ``ms`` is CUDA events over back-to-back calls (what a caller waits,
host dispatch included), ``device_ms`` torch.profiler's device time (K2:
its kernel; the selects: every kernel of a call). Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs   # its timers; it puts this checkout's src on the path

    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("select_times: torch sees no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist
    from repro_torch.core.scoring import HeteRoScoreConfig, diversity_decay
    from repro_torch.core.selection import SelectorConfig, dynamic_temperature, gumbel_noise
    from repro_torch.core.state import to_bf16
    from repro_torch.data import synthetic_client_state
    from repro_torch.kernels import ops
    from repro_torch.kernels import score_select as tss

    dev = torch.device("cuda")
    print(cs.nvidia_smi(), flush=True)

    def emit(row):
        print(json.dumps({"tag": args.tag, **row}), flush=True)

    cfg = HeteRoScoreConfig()
    t = 9
    tau = float(dynamic_temperature(t, SelectorConfig()))
    decay = float(diversity_decay(t, cfg))
    for k, m, dtype in ((12, 6, torch.float32), (1 << 20, 1024, torch.float32),
                        (1 << 20, 1024, torch.bfloat16)):
        gen = torch.Generator(device=dev).manual_seed(k)
        rows = cs.random_rows(k, dtype, gen, t)
        blk, nblocks, kpad = tss._layout(k)
        stacked = tss._pack(rows, None, k, kpad)
        glob = tss._combine_stats(tss.score_stats_plain(stacked, k=k, block=blk))
        gpad = torch.nn.functional.pad(gumbel_noise(gen, k), (0, kpad - k))
        kw = dict(k=k, block=blk, t=float(t), tau=tau, use_ov=False, decay=decay, cfg=cfg,
                  mb=min(m, blk))
        fn = lambda: tss.score_select(stacked, glob, gpad, **kw)
        iters = 200 if k < 4096 else 50
        emit({"what": "K2", "K": k, "m": m, "dtype": str(dtype).split(".")[-1],
              "ms": cs.time_ms(fn, iters), "device_ms": cs.device_ms(fn, "select_kernel")})

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{cs.free_port()}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        rnd = 7
        for k in (1_000, 1_000_000):
            m = k // 1000
            tau = dynamic_temperature(rnd, SelectorConfig(num_selected=m))
            state = to_bf16(synthetic_client_state(k, seed=0, device=dev))
            gumbel = gumbel_noise(torch.Generator(device=dev).manual_seed(k), k)
            methods = {
                "fused": lambda: ops.heterosel_topm(state, rnd, tau, m, gumbel, cfg),
                "sharded": lambda: ops.heterosel_topm_sharded(
                    state, rnd, tau, m, gumbel, cfg, group=dist.group.WORLD)}
            for name, fn in methods.items():
                row = {"what": name, "K": k, "m": m, "dtype": "bfloat16",
                       "ms": cs.time_ms(fn, 50), "device_ms": cs.device_ms(fn, None, iters=10)}
                if name == "sharded":
                    row["collectives_per_call"] = sum(cs.count_collectives(fn).values())
                emit(row)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
