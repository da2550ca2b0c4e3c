#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

  1. Device and build: the card's name and power limit (nvidia-smi), then
     the sm_90a builds, from src/repro_torch/kernels/csrc/, of the fused
     HeteRo-Select kernels K1–K4 (score_select.cu), the flash-attention
     kernel K5 (flash_attention.cu), the grouped matmul K6 (moe_gmm.cu) and
     the SSD chunk kernel K7 (ssd_scan.cu), one nvcc each, started together,
     with their ptxas reports, and K7's SASS checked for TF32 tensor-core
     mma instructions.
  2. Kernels against their plain PyTorch versions on the card, f32 and bf16
     state, staleness override off and on: K1 + K2 for K ∈ {12, 4133, 2^20}
     and m ∈ {6, 64, 1024} (m ≤ K), selected sets equal; K3 for the same K;
     K4 for the edge layouts in K4_CASES, padding slots exactly 0.0. Scores
     and probabilities must agree to 1e-5 relative. K5 for the cases in
     FLASH_CASES (f32 and bf16, causal and not, window 256, GQA 14/2 and
     MHA at D = 64, S = T ∈ {32, 1000, 4096}, D = 256, and kimi-k2's 64/8
     heads of D = 112): f32 outputs to 1e-5 relative (1e-6 absolute), bf16
     outputs within one bf16 ulp of the plain version's plus 1e-6, the
     log-sum-exp to 1e-5. K6 for the cases in GMM_CASES (phase 7's folded
     launches, gate/up and down, per-client, shared and transposed weights;
     the eval's unfolded launch; empty groups, one group with every row and
     rows past the last group; bf16 and f32): the rows that are 0 the same
     rows, bf16 within one bf16 ulp plus 1e-5 of the largest output, f32 to
     1e-5 relative plus 1e-5 of the largest (summation order only). K7 (C·Bᵀ
     once per batch row and chunk, then every head's W·x and state on the
     tensor cores in 3xTF32) for the cases in SSD_CASES (f32): y_intra,
     states and cum_last to 1e-5 relative plus 1e-5 of the largest entry;
     its timing rows carry both bounds, the f32 CUDA-core one and the
     3xTF32 tensor-core one. And ops.ssd_forward through K7 against the
     plain sequential recurrence to 1e-4 (relative and of the largest
     entry). K8's offset: K = 2^20 (f32 and bf16) split into K8_WORLD
     client shards of this process, K1 and K2 on each shard with its global
     offset and limit against their plain versions with the same offset
     (candidate ids exactly), and the shards merged by the collectives'
     arithmetic on local tensors, which must select the single-device
     fused cohort: the only world size above 1 one card can check. Then
     each kernel and its plain version are timed: CUDA events
     around back-to-back calls (what a caller waits, host dispatch included)
     and torch.profiler's device time; K5 also beside torch's
     scaled_dot_product_attention on the same inputs (a yardstick only: the
     port never calls it); K6 beside torch._grouped_mm, where torch has it,
     on the same rows in groups and weights (likewise never called by the
     port).
  3. The flat main path at full width: Algorithm 1 sync/flat with
     selector="heterosel_pallas" on ResNet-18 (d_model 64, 32×32×3, 10
     classes), K = 12, m = 6, 3 rounds of 4 local steps, batched executor.
     Launch counts are zeroed just before and read just after; each round
     must launch K1 and K2 once, and its cohort must equal the plain
     versions' selection on the same state and noise.
  4. The hierarchical path at full width: the same model, K = 24 clients in
     E = 4 similarity edges (budgets of 3), 3 edges per round, 3 rounds of
     4 local steps, heterosel_pallas, batched executor. Each round must
     launch K4 once and nothing else, give the probs and scores K4's plain
     version gives on the same edge-major state (the engine's own
     ``select_round`` with the plain scorer), upload 3 edge aggregates,
     select 9 clients, and select the plain versions' cohort.
  5. The federated LM path at full width: examples/federated_llm.py's setup
     (K = 8, m = 4, 1 local epoch of 3 steps, batch 8, lr 0.05, μ 0.1,
     make_lm_data(seq_len=32)) on qwen2-0.5b with all 24 layers (494 M
     params, bf16), 3 rounds, heterosel_pallas, batched executor. Each round
     must launch K1 and K2 once and K5 24 × (3 + 1) = 96 times (one launch
     per layer per local step for the whole vmapped cohort, none in the
     backward, one per layer in the eval), and select the plain versions'
     cohort. Then one eval forward through K5 is held against the same
     forward through K5's plain version.
  6. The same federated LM setup on mamba2-370m with all 48 layers (368 M
     params), at make_lm_data(seq_len=256) (see SSM_SEQ): each sequence
     one 256-row SSD chunk. Each round must launch K1 and K2 once
     and K7 48 × (3 + 1) = 192 times, no K5, and select the plain versions'
     cohort; one eval forward through K7 is held against the same forward
     through K7's plain version.
  7. The same federated LM setup on one device's share of kimi-k2-1t-a32b:
     every published width (d_model 7168, 64 query and 8 KV heads of 112,
     expert d_ff 2048, the router over all 384 experts, top-8), the weights
     of experts 0–7 of 384 (one of 48 devices of an expert-parallel
     deployment), 20 480 of the 163 840 vocabulary rows, 2 layers (see
     MOE_SHARE). Each round must launch K1 and K2 once, K5 2 × (3 + 1) = 8
     times and K6 2 × (3 × (3 + 3) + 3) = 42 times (three grouped products
     per layer per forward and three dX products per backward, each one
     launch for the whole vmapped cohort; none for dW), no K7, and select
     the plain versions' cohort; one eval forward through K6 is held against
     the same forward through K6's plain version. Phases 5–7 print their peak
     memory beside the one recorded before the client visit stopped keeping
     a graph of each backward and every leaf's f32 delta (PEAK_BEFORE).
  8. The selection control plane at population scale, the reference's Table
     8: K ∈ {10^3, 10^4, 10^5, 10^6}, m = K/1000, a bf16 client state; the
     unfused heterosel, the fused K1 + K2 and the sharded K8 on a one-rank
     NCCL group (made here) each select once at every K with the launch
     counts zeroed before and read after; fused and sharded bitwise equal,
     all three cohorts equal as sets; each timed (select_ms, device ms).
  9. The paper's Table I on full-width ResNet-18: its five selectors
     (heterosel, heterosel_mult, oort, power_of_choice, random) on phase 3's
     federation, flat, TABLE1_ROUNDS rounds, the same draws for each; each
     selector's peak, final, stability drop, select_ms and execute_ms.
 10. A JSON line of per-kernel numbers, then the result line.

It needs one card, imports nothing of JAX or of the reference package, and
exits nonzero without printing a result when torch sees no CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
CHECK_KS = (12, 4096 + 37, 1 << 20)
CHECK_MS = (6, 64, 1024)
TIMED = ((12, 6), (1 << 20, 1024))   # (K, m); K = 12 is the main path's shape
# K4 edge layouts: (name, sizes, seg). K = 24, E = 4 (sizes 6, seg one warp)
# is the hierarchical phase's shape.
K4_CASES = (("K=24 E=4", [6] * 4, 32),
            ("ragged", [5, 128, 60], 128),
            ("E=1 K=4133", [4133], 4133),
            ("K=1024 E=32", [32] * 32, 32),
            ("K=2^20 E=1024", [1024] * 1024, 1024),
            ("K=2^20 E=32", [32768] * 32, 32768))
K4_TIMED = (("K=24 E=4", [6] * 4, 32), ("K=2^20 E=1024", [1024] * 1024, 1024))
RTOL = 1e-5
# K5 cases: (name, B, S, T, H, KVH, D, causal, window). "path" is the LM
# phase's shape: a cohort of 4 clients × batch 8 (or 32 eval sequences) of 32
# tokens, qwen2-0.5b's 14 query and 2 KV heads of 64.
FLASH_CASES = (("path", 32, 32, 32, 14, 2, 64, True, 0),
               ("path non-causal", 32, 32, 32, 14, 2, 64, False, 0),
               ("T=1000", 1, 1000, 1000, 14, 2, 64, True, 0),
               ("T=1000 non-causal", 1, 1000, 1000, 14, 2, 64, False, 0),
               ("T=1000 window 256", 1, 1000, 1000, 14, 2, 64, True, 256),
               ("prefill 4096", 1, 4096, 4096, 14, 2, 64, True, 0),
               ("MHA T=1000", 2, 1000, 1000, 14, 14, 64, True, 0),
               ("D=256", 1, 300, 300, 4, 2, 256, True, 0),
               ("kimi path", 32, 32, 32, 64, 8, 112, True, 0),
               ("D=112 T=1000", 1, 1000, 1000, 64, 8, 112, True, 0))
FLASH_TIMED = ("path", "prefill 4096", "kimi path")
# Dense peaks of one H100 SXM (NVIDIA data sheet): bf16 inputs on the tensor
# cores, which accumulate in f32, so K5's f32 state does not force the CUDA
# cores; f32 inputs have no tensor-core path with TF32 off.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Dense TF32 on the tensor cores (NVIDIA data sheet), for K7's 3xTF32 bound:
# three TF32 products for each f32 product.
PEAK_TF32 = 494.7e12
# K7 cases: (name, B, S, CL, NH, HP, N). "path" is the shape K7 takes in
# phase 6: a cohort of 4 clients × batch 8 (or 32 eval sequences), one
# 256-row chunk (phase 6's 256 tokens),
# mamba2-370m's 32 heads of 64 and state 128. "CL 100" is neither a multiple
# of the kernel's 16-row mma tile nor of its 64-row CTA tile (three chunks);
# "HP 128 N 256" is the largest head and state the kernel takes.
SSD_CASES = (("path", 32, 256, 256, 32, 64, 128),
             ("ragged", 3, 300, 128, 5, 64, 128),
             ("smoke", 8, 32, 32, 16, 32, 16),
             ("prefill 4096", 1, 4096, 256, 32, 64, 128),
             ("CL 100", 4, 250, 100, 8, 64, 128),
             ("HP 128 N 256", 2, 512, 256, 4, 128, 256))
SSD_TIMED = ("path", "prefill 4096")
SSD_FORWARD_RTOL = 1e-4
# Phase 6's sequence length: one full chunk of mamba2-370m's ssm_chunk. The
# example's 32 tokens would make K7 compute a 256-row chunk that is 7/8
# padding. While the client visit took its gradient with torch.func.grad
# (which records every op's backward), a 48-layer cohort step needed 77 GB
# at 256 and the phase ran at 128; the visit's vjp keeps no such graph.
SSM_SEQ = 256
LM_ROUNDS = 3
LM_STEPS = 3
# Phase 7's cut of kimi-k2-1t-a32b (registry.expert_share): 8 of the 384
# experts, 20 480 of the 163 840 vocabulary rows, 2 of the 61 layers; every
# width as published. 1 234 996 224 params, 2.48 GB.
MOE_SHARE = dict(experts_here=8, first_expert=0, vocab_size=20480, num_layers=2)
# K6 cases: (name, clients, rows per client, K, N, groups, rhs, sizes). The
# "path" sizes are drawn as the share routes phase 7's tokens: each client's
# rows are its 8 × 32 tokens' top-8 pairs over 384 experts, ~1/48 of them to
# the 8 here and the rest past the last group. "path gate" and "path down"
# are phase 7's folded launches (4 clients × 8 experts; per-client weights
# after the first local step, shared weights on it), "down dX" the backward
# of the down product (dY @ w_downᵀ through a transposed view), "eval gate"
# the eval's unfolded launch (32 sequences of 32 tokens).
GMM_CASES = (("path gate", 4, 2048, 7168, 2048, 8, "client", "path"),
             ("path down", 4, 2048, 2048, 7168, 8, "shared", "path"),
             ("down dX", 4, 2048, 7168, 2048, 8, "transposed", "path"),
             ("eval gate", 1, 8192, 7168, 2048, 8, "shared", "path"),
             ("ragged", 2, 1000, 256, 384, 4, "client", [[0, 1000, 0, 0], [300, 0, 500, 0]]))
GMM_F32 = ("path gate", "ragged")
GMM_TIMED = ("path gate", "path down", "eval gate")
# K8's offset check: K = 2^20 split into K8_WORLD client shards of one process.
K8_CHECK = (1 << 20, 1024)           # (K, m)
K8_WORLD = 4
# Phase 8, the reference's Table 8 (benchmarks/table8_selector.py): K from
# 10^3 to 10^6, m = max(round(10^-3·K), 1), round 7, a bf16 client state.
TABLE8_KS = (1_000, 10_000, 100_000, 1_000_000)
TABLE8_ROUND = 7
# Phase 9, the paper's Table I: its five selectors on phase 3's federation.
TABLE1_ROUNDS = 20
# Peak memory of phases 5-7 before the client visit dropped the recorded
# backward and the all-at-once f32 deltas (this script's run on an H100
# 80GB HBM3 at 700 W, before that change): printed beside this run's.
# By phase; phase 6 ran at seq 128 then (it needed 77 GB at 256).
PEAK_BEFORE = {5: (20_444_054_016, 32), 6: (47_652_597_760, 128),
               7: (48_821_506_048, 32)}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str, names) -> list:
    """Registers, spill bytes and static shared memory of each entry function
    of a ptxas -v log whose mangled name holds one of ``names``."""
    import re

    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = next((n for n in names if n in m.group(1)), None)
            if cur:
                rows.append({"kernel": cur, "mangled": m.group(1)})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rows[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1].update(registers=int(m.group(1)),
                            static_smem=int(smem.group(1)) if smem else 0)
    return rows


def sass_tf32_mma(so_path, names) -> dict:
    """Count of TF32 tensor-core mma instructions (HMMA.1688.F32.TF32) in the
    SASS of each kernel of a built library whose mangled name holds one of
    ``names`` (cuobjdump -sass, beside nvcc)."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(so_path)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts = {}
    for block in out.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if any(n in name for n in names):
            counts[name] = block.count("HMMA.1688.F32.TF32")
    return counts


def random_rows(k: int, dtype, gen, t: int = 9):
    """Eight (K,) rows of a mid-run state on the generator's device, with
    never-selected clients, in ``score_inputs`` order."""
    import torch
    from repro_torch.core.state import NEVER

    dev = gen.device

    def u():
        return torch.rand(k, generator=gen, device=dev)

    has_loss = u() > 0.3
    has_mom = has_loss & (u() > 0.5)
    zero = torch.zeros((), device=dev)
    rows = [
        torch.where(has_loss, 0.1 + 3.9 * u(), zero),
        torch.where(has_mom, 0.1 + 3.9 * u(), zero),
        0.69 * u(),
        torch.where(has_loss, torch.randint(1, 6, (k,), generator=gen, device=dev), 0
                    ).to(torch.int32),
        torch.where(has_loss, torch.randint(0, t, (k,), generator=gen, device=dev), NEVER
                    ).to(torch.int32),
        torch.where(has_loss, 2.0 * u(), zero),
        has_loss.to(torch.float32),
        has_mom.to(torch.float32),
    ]
    return [r if r.dtype == torch.int32 else r.to(dtype) for r in rows]


def check_close(name: str, got, want, rtol: float = RTOL, atol: float = 0.0) -> float:
    """Raise unless |got − want| ≤ atol + rtol·|want| everywhere; return the
    largest absolute error."""
    import torch

    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{name}: {m}")
    return float((got.double() - want.double()).abs().max())


def kernel_bytes(k: int, itemsize: int, nblocks: int, mb: int, use_ov: bool):
    """Bytes K1, K2 and K3 must move for K clients: each input read once and
    each output written once (padding columns not counted)."""
    k1 = 4 * k * itemsize + nblocks * 5 * 4
    rows = 8 + (1 if use_ov else 0)
    k3 = (rows * k * itemsize + 4 * 4                  # state rows, glob
          + 2 * 4 * k + nblocks * 2 * 4)               # scores, e, (m_b, l_b)
    k2 = k3 + 4 * k + nblocks * mb * 8                 # + Gumbel, candidates
    return k1, k2, k3


def segment_bytes(sizes, seg: int, itemsize: int, use_ov: bool) -> int:
    """Bytes K4 must move: the state rows of each valid client read once, the
    sizes read, probs and scores written for every slot of the layout."""
    rows = 8 + (1 if use_ov else 0)
    return rows * sum(sizes) * itemsize + 4 * len(sizes) + 2 * 4 * len(sizes) * seg


def time_ms(fn, iters: int) -> float:
    """Device time per call of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str | None, iters: int = 20):
    """Device time per call from torch.profiler: the named kernel's time, or
    with ``kernel=None`` every CUDA kernel's. None if the trace shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.self_device_time_total > 0 and (kernel is None or kernel in e.key))
    return us / iters / 1e3 if us > 0 else None


def phase_kernels(dev):
    """Phase 2: every case against the plain versions, then the timings."""
    import torch
    from repro_torch.core.scoring import HeteRoScoreConfig, diversity_decay
    from repro_torch.core.selection import SelectorConfig, dynamic_temperature
    from repro_torch.kernels import score_select as tss

    cfg = HeteRoScoreConfig()
    t = 9
    tau = dynamic_temperature(t, SelectorConfig())
    decay = float(diversity_decay(t, cfg))
    err = {"score_stats": 0.0, "score_select": 0.0, "score_probs": 0.0,
           "segment_probs": 0.0}
    ncases = 0
    for k in CHECK_KS:
        for dtype in (torch.float32, torch.bfloat16):
            for use_ov in (False, True):
                gen = torch.Generator(device=dev).manual_seed(k + 7 * use_ov)
                rows = random_rows(k, dtype, gen, t)
                gumbel = -torch.log(-torch.log(
                    torch.rand(k, generator=gen, device=dev).clamp_min(1e-38)))
                stale = 30.0 * torch.rand(k, generator=gen, device=dev) if use_ov else None
                blk, nblocks, kpad = tss._layout(k)
                stacked = tss._pack(rows, stale, k, kpad)
                # K1 alone
                stats_k = tss.score_stats(stacked, k=k, block=blk)
                stats_p = tss.score_stats_plain(stacked, k=k, block=blk)
                err["score_stats"] = max(err["score_stats"], check_close(
                    f"K1 K={k} {dtype}", stats_k, stats_p))
                # K2 alone, on the same global statistics
                glob = tss._combine_stats(stats_p)
                gpad = torch.nn.functional.pad(gumbel, (0, kpad - k))
                for m in (m for m in CHECK_MS if m <= k):
                    kw = dict(k=k, block=blk, t=float(t), tau=float(tau),
                              use_ov=use_ov, decay=decay, cfg=cfg, mb=min(m, blk))
                    out_k = tss.score_select(stacked, glob, gpad, **kw)
                    out_p = tss.score_select_plain(stacked, glob, gpad, **kw)
                    where = f"K2 K={k} m={m} {dtype} override={use_ov}"
                    e2 = max(check_close(f"{where} scores", out_k[0], out_p[0], atol=1e-6),
                             check_close(f"{where} exp", out_k[1], out_p[1], atol=1e-30),
                             check_close(f"{where} (m_b, l_b)", out_k[2], out_p[2]))
                    err["score_select"] = max(err["score_select"], e2)
                    # The whole fused selection through kernels vs plain.
                    fkw = dict(round_idx=t, tau=tau, m=m, gumbel=gumbel, cfg=cfg,
                               staleness_override=stale)
                    sel_k, probs_k, scores_k = tss.fused_score_select(*rows, **fkw)
                    sel_p, probs_p, scores_p = tss.fused_score_select_plain(*rows, **fkw)
                    if set(sel_k.tolist()) != set(sel_p.tolist()):
                        raise AssertionError(f"{where}: selected sets differ")
                    check_close(f"{where} probs", probs_k, probs_p, atol=1e-30)
                    check_close(f"{where} fused scores", scores_k, scores_p, atol=1e-6)
                    ncases += 1
    torch.cuda.synchronize()
    print(f"phase 2: {ncases} cases, kernels == plain (sets equal, rtol {RTOL}); "
          f"max abs err K1 {err['score_stats']:.3e}, K2 {err['score_select']:.3e}",
          flush=True)
    check_probs_kernels(dev, err, t, tau, cfg)

    timings = []
    for k, m in TIMED:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(k)
            rows = random_rows(k, dtype, gen, t)
            blk, nblocks, kpad = tss._layout(k)
            stacked = tss._pack(rows, None, k, kpad)
            glob = tss._combine_stats(tss.score_stats_plain(stacked, k=k, block=blk))
            gpad = torch.nn.functional.pad(
                -torch.log(-torch.log(torch.rand(k, generator=gen, device=dev))), (0, kpad - k))
            mb = min(m, blk)
            kw3 = dict(k=k, block=blk, t=float(t), tau=float(tau), use_ov=False,
                       decay=decay, cfg=cfg)
            kw = dict(kw3, mb=mb)
            iters = 200 if k < 4096 else 50
            row = {"K": k, "m": m, "dtype": str(dtype).split(".")[-1], "block": blk,
                   "nblocks": nblocks}
            row["k1_ms"] = time_ms(lambda: tss.score_stats(stacked, k=k, block=blk), iters)
            row["k1_plain_ms"] = time_ms(
                lambda: tss.score_stats_plain(stacked, k=k, block=blk), iters)
            row["k2_ms"] = time_ms(lambda: tss.score_select(stacked, glob, gpad, **kw), iters)
            row["k2_plain_ms"] = time_ms(
                lambda: tss.score_select_plain(stacked, glob, gpad, **kw), iters)
            row["k1_device_ms"] = device_ms(
                lambda: tss.score_stats(stacked, k=k, block=blk), "stats_kernel")
            row["k1_plain_device_ms"] = device_ms(
                lambda: tss.score_stats_plain(stacked, k=k, block=blk), None)
            row["k2_device_ms"] = device_ms(
                lambda: tss.score_select(stacked, glob, gpad, **kw), "select_kernel")
            row["k2_plain_device_ms"] = device_ms(
                lambda: tss.score_select_plain(stacked, glob, gpad, **kw), None)
            row["k3_ms"] = time_ms(lambda: tss.score_probs(stacked, glob, **kw3), iters)
            row["k3_plain_ms"] = time_ms(
                lambda: tss.score_probs_plain(stacked, glob, **kw3), iters)
            row["k3_device_ms"] = device_ms(
                lambda: tss.score_probs(stacked, glob, **kw3), "select_kernel")
            row["k3_plain_device_ms"] = device_ms(
                lambda: tss.score_probs_plain(stacked, glob, **kw3), None)
            b1, b2, b3 = kernel_bytes(k, stacked.element_size(), nblocks, mb, False)
            row["k1_bound_ms"] = b1 / HBM_BYTES_PER_S * 1e3
            row["k2_bound_ms"] = b2 / HBM_BYTES_PER_S * 1e3
            row["k3_bound_ms"] = b3 / HBM_BYTES_PER_S * 1e3
            timings.append(row)
            print("timing " + json.dumps(row), flush=True)

    for name, sizes, seg in K4_TIMED:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(len(sizes) * seg)
            stacked = tss._pack(random_rows(len(sizes) * seg, dtype, gen, t), None,
                                len(sizes) * seg, len(sizes) * seg)
            sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
            kw4 = dict(seg=seg, t=float(t), tau=float(tau), use_ov=False, decay=decay,
                       cfg=cfg)
            iters = 200 if len(sizes) * seg < 4096 else 50
            row = {"case": name, "E": len(sizes), "seg": seg, "K": sum(sizes),
                   "dtype": str(dtype).split(".")[-1]}
            row["k4_ms"] = time_ms(lambda: tss.segment_probs(stacked, sz, **kw4), iters)
            row["k4_plain_ms"] = time_ms(
                lambda: tss.segment_probs_plain(stacked, sz, **kw4), iters)
            row["k4_device_ms"] = device_ms(
                lambda: tss.segment_probs(stacked, sz, **kw4), "segment_kernel")
            row["k4_plain_device_ms"] = device_ms(
                lambda: tss.segment_probs_plain(stacked, sz, **kw4), None)
            row["k4_bound_ms"] = segment_bytes(sizes, seg, stacked.element_size(),
                                               False) / HBM_BYTES_PER_S * 1e3
            timings.append(row)
            print("timing " + json.dumps(row), flush=True)
    return err, timings


def check_probs_kernels(dev, err: dict, t: int, tau, cfg) -> None:
    """Phase 2, K3 and K4: each case on the card against its plain version."""
    import torch
    from repro_torch.kernels import score_select as tss

    ncases = 0
    for k in CHECK_KS:
        for dtype in (torch.float32, torch.bfloat16):
            for use_ov in (False, True):
                gen = torch.Generator(device=dev).manual_seed(3 * k + use_ov)
                rows = random_rows(k, dtype, gen, t)
                stale = 30.0 * torch.rand(k, generator=gen, device=dev) if use_ov else None
                kw = dict(round_idx=t, tau=tau, cfg=cfg, staleness_override=stale)
                probs_k, scores_k = tss.fused_score_probs(*rows, **kw)
                probs_p, scores_p = tss.fused_score_probs_plain(*rows, **kw)
                where = f"K3 K={k} {dtype} override={use_ov}"
                err["score_probs"] = max(
                    err["score_probs"],
                    check_close(f"{where} scores", scores_k, scores_p, atol=1e-6),
                    check_close(f"{where} probs", probs_k, probs_p, atol=1e-30))
                ncases += 1
    for name, sizes, seg in K4_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for use_ov in (False, True):
                k = len(sizes) * seg
                gen = torch.Generator(device=dev).manual_seed(k + seg + use_ov)
                rows = random_rows(k, dtype, gen, t)
                stale = 30.0 * torch.rand(k, generator=gen, device=dev) if use_ov else None
                kw = dict(sizes=sizes, round_idx=t, tau=tau, cfg=cfg, seg=seg,
                          staleness_override=stale)
                probs_k, scores_k = tss.segmented_score_probs(*rows, **kw)
                probs_p, scores_p = tss.segmented_score_probs_plain(*rows, **kw)
                where = f"K4 {name} {dtype} override={use_ov}"
                err["segment_probs"] = max(
                    err["segment_probs"],
                    check_close(f"{where} scores", scores_k, scores_p, atol=1e-6),
                    check_close(f"{where} probs", probs_k, probs_p, atol=1e-30))
                valid = torch.arange(seg, device=dev)[None, :] < torch.tensor(
                    sizes, device=dev)[:, None]
                pad = ~valid.reshape(-1)
                if bool((probs_k[pad] != 0).any()) or bool((scores_k[pad] != 0).any()):
                    raise AssertionError(f"{where}: a padding slot is not 0.0")
                sums = probs_k.view(len(sizes), seg).sum(1).double()
                if not bool(((sums - 1.0).abs() < 1e-5).all()):
                    raise AssertionError(f"{where}: per-edge sums {sums.tolist()[:4]}…")
                ncases += 1
    torch.cuda.synchronize()
    print(f"phase 2: {ncases} K3/K4 cases, kernels == plain (rtol {RTOL}, padding "
          f"0.0); max abs err K3 {err['score_probs']:.3e}, "
          f"K4 {err['segment_probs']:.3e}", flush=True)


def flash_inputs(case, dtype, dev, seed=0):
    import torch

    _, b, s, t, h, kvh, d = case[:7]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, s, h, d), (b, t, kvh, d), (b, t, kvh, d))]


def bf16_ulp(x):
    """Spacing of bf16 at |x| (8 significant bits)."""
    import torch

    e = torch.floor(torch.log2(torch.clamp_min(x.abs().float(), 2.0 ** -126)))
    return torch.exp2(e - 7)


def check_within_bf16_ulp(name: str, got, want, atol: float = 1e-6) -> float:
    """Raise unless every bf16 entry of ``got`` is within one bf16 ulp of
    ``want`` plus ``atol``; return the largest absolute error. The ``atol``
    is the f32 error before the cast: where p·v cancels to near 0, two f32
    sum orders differ by more than one bf16 ulp of the result (up to ~5e-7
    against f64 at these shapes)."""
    gap = (got.float() - want.float()).abs()
    if not bool((gap <= bf16_ulp(want) + atol).all()):
        raise AssertionError(f"{name}: {float(gap.max()):.3e} exceeds one bf16 ulp "
                             f"+ {atol}")
    return float(gap.max())


def flash_work(case, itemsize: int):
    """(bytes, flops) K5 must spend on a case: q, k, v read once, o and the
    f32 log-sum-exp written once; 4·D flops (q·k and p·v) per unmasked
    (query, key) pair of each (batch, head)."""
    _, b, s, t, h, kvh, d, causal, window = case
    qp = np.arange(s)
    hi = np.minimum(qp, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(s, np.int64)
    pairs = int(np.clip(hi - lo + 1, 0, None).sum())
    nbytes = (2 * b * s * h * d + 2 * b * t * kvh * d) * itemsize + b * h * s * 4
    return nbytes, 4 * d * pairs * b * h


def sdpa(q, k, v, causal: bool):
    """torch's fused attention on K5's inputs: the yardstick, never on the
    port's path."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=k.shape[2] != q.shape[2]).transpose(1, 2)


def phase_flash(dev):
    """Phase 2, K5: every case against the plain version, then the timings."""
    import torch
    from repro_torch.kernels import flash_attention as tfa

    err = {"float32": 0.0, "bfloat16": 0.0}
    for case in FLASH_CASES:
        name, causal, window = case[0], case[7], case[8]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(case, dtype, dev)
            o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
            o_p, lse_p = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
            where = f"K5 {name} {dtype}"
            key = str(dtype).split(".")[-1]
            if dtype == torch.bfloat16:
                e = check_within_bf16_ulp(f"{where} o", o, o_p)
            else:
                e = check_close(f"{where} o", o, o_p, atol=1e-6)
            check_close(f"{where} lse", lse, lse_p, atol=1e-5)
            err[key] = max(err[key], e)
    torch.cuda.synchronize()
    print(f"phase 2: {2 * len(FLASH_CASES)} K5 cases, kernel == plain (f32 rtol {RTOL}, "
          f"bf16 within 1 ulp + 1e-6); max abs err f32 {err['float32']:.3e}, bf16 "
          f"{err['bfloat16']:.3e}", flush=True)

    timings = []
    for case in (c for c in FLASH_CASES if c[0] in FLASH_TIMED):
        name, causal, window = case[0], case[7], case[8]
        small = case[2] <= 64
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_inputs(case, dtype, dev, seed=1)
            key = str(dtype).split(".")[-1]
            kname = "flash_fwd_kernel_wgmma" if dtype == torch.bfloat16 else "flash_fwd_kernel"
            row = {"case": name, "dtype": key, "kernel": kname, "B": case[1], "S": case[2],
                   "T": case[3], "H": case[4], "KVH": case[5], "D": case[6], "causal": causal}
            kern = lambda: tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
            plain = lambda: tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
            row["k5_ms"] = time_ms(kern, 200 if small else 20)
            row["k5_plain_ms"] = time_ms(plain, 50 if small else 3)
            row["k5_device_ms"] = device_ms(kern, kname)
            row["k5_plain_device_ms"] = device_ms(plain, None, iters=5)
            lib = lambda: sdpa(q, k, v, causal)
            row["sdpa_max_abs_diff"] = float((lib().float() - kern()[0].float()).abs().max())
            row["k5_library_ms"] = time_ms(lib, 200 if small else 20)
            row["k5_library_device_ms"] = device_ms(lib, None)
            nbytes, flops = flash_work(case, q.element_size())
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[key] * 1e3
            row.update(bytes=nbytes, flops=flops, k5_bound_ms=max(t_bytes, t_ops),
                       k5_bound_by="bytes" if t_bytes >= t_ops else "operations")
            timings.append(row)
            print("timing " + json.dumps(row), flush=True)
    return err, timings


def ssd_inputs(case, dev, seed=0):
    """x, dt, a_neg, b, c of ``ops.ssd_forward`` at the model's scales: dt =
    softplus(N(−2, 0.5)) (≈ 0.13, as at init), A = −exp(N(0, 0.3))."""
    import torch
    import torch.nn.functional as F

    _, b, s, _, nh, hp, n = case
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    return (r(b, s, nh, hp), F.softplus(-2.0 + 0.5 * r(b, s, nh)), -torch.exp(0.3 * r(nh)),
            r(b, s, n), r(b, s, n))


def ssd_work(case):
    """(bytes, flops) K7 must spend on a case's chunked operands: x, dt,
    a_neg, b, c read once, y_intra, states and cum_last written once (f32);
    the causal half of C·Bᵀ once per (batch, chunk), and per (batch, chunk,
    head) the causal half of W·x, 4 operations per causal weight (difference,
    exp, two products), x_j·v_j and the state product."""
    _, b, s, cl, nh, hp, n = case
    nc = -(-s // cl)
    tri = cl * (cl + 1) // 2
    nbytes = 4 * (2 * b * nc * cl * nh * hp + b * nc * cl * nh + b * nh + 2 * b * nc * cl * n
                  + b * nc * nh * hp * n + b * nc * nh)
    flops = b * nc * 2 * tri * n + b * nc * nh * (2 * tri * hp + 4 * tri + cl * hp
                                                  + 2 * cl * hp * n)
    return nbytes, flops


def check_scaled(name: str, got, want, rtol: float) -> float:
    """Raise unless |got − want| ≤ rtol·(|want| + max|want|) everywhere;
    return the largest absolute error."""
    return check_close(name, got, want, rtol=rtol, atol=rtol * float(want.abs().max()))


def phase_ssd(dev):
    """Phase 2, K7: every case against the plain version, and
    ``ops.ssd_forward`` through K7 against the plain recurrence; then the
    timings. Returns K7's largest error, the forward's, and the rows."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as tssd

    err = fwd_err = 0.0
    for case in SSD_CASES:
        name, bsz, cl, nh = case[0], case[1], case[3], case[4]
        x, dt, a, b, c = ssd_inputs(case, dev)
        xc, dtc, bc, cc = tssd.to_chunks(x, dt, b, c, cl)
        a_rows = a.expand(bsz, nh)
        got = tssd.ssd_chunk(xc, dtc, a_rows, bc, cc)
        want = tssd.ssd_chunk_plain(xc, dtc, a_rows, bc, cc)
        for what, g, w in zip(("y_intra", "states", "cum_last"), got, want):
            err = max(err, check_scaled(f"K7 {name} {what}", g, w, RTOL))
        # The whole SSD (K7, the cross-chunk recurrence, the correction)
        # against the definition. The recurrence multiplies up to S f32
        # decays one at a time, the chunked form takes exp of summed logs.
        y, h = ops.ssd_forward(x, dt, a, b, c, chunk=cl)
        ry, rh = tssd.ssd_recurrence(x, dt, a, b, c)
        fwd_err = max(fwd_err, check_scaled(f"ssd_forward {name} y", y, ry, SSD_FORWARD_RTOL),
                      check_scaled(f"ssd_forward {name} h", h, rh, SSD_FORWARD_RTOL))
    torch.cuda.synchronize()
    print(f"phase 2: {len(SSD_CASES)} K7 cases, kernel == plain (rtol {RTOL} and {RTOL} of "
          f"the max); max abs err {err:.3e}; ssd_forward == recurrence (rtol "
          f"{SSD_FORWARD_RTOL}), max abs err {fwd_err:.3e}; heads kernel CTAs per SM at "
          f"HP 32/64/128: {[tssd.occupancy(hp) for hp in (32, 64, 128)]}", flush=True)

    timings = []
    for case in (c for c in SSD_CASES if c[0] in SSD_TIMED):
        name, bsz, s, cl, nh, hp, n = case
        x, dt, a, b, c = ssd_inputs(case, dev, seed=1)
        xc, dtc, bc, cc = tssd.to_chunks(x, dt, b, c, cl)
        a_rows = a.expand(bsz, nh)
        kern = lambda: tssd.ssd_chunk(xc, dtc, a_rows, bc, cc)
        plain = lambda: tssd.ssd_chunk_plain(xc, dtc, a_rows, bc, cc)
        row = {"case": name, "B": bsz, "S": s, "CL": cl, "NC": xc.shape[1], "NH": nh,
               "HP": hp, "N": n}
        row["k7_ms"] = time_ms(kern, 20)
        row["k7_plain_ms"] = time_ms(plain, 5)
        # Both kernels of a call (ssd_chunk_cb_kernel, ssd_chunk_heads_kernel).
        row["k7_device_ms"] = device_ms(kern, "ssd_chunk_")
        row["k7_plain_device_ms"] = device_ms(plain, None, iters=5)
        nbytes, flops = ssd_work(case)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        # The f32 CUDA-core bound (PR 14's design), and the 3xTF32
        # tensor-core bound of this design: each beside the byte bound.
        t_f32 = flops / PEAK_FLOPS["float32"] * 1e3
        t_tc = 3 * flops / PEAK_TF32 * 1e3
        row.update(bytes=nbytes, flops=flops, k7_bytes_ms=t_bytes,
                   k7_bound_f32_ms=max(t_bytes, t_f32), k7_bound_ms=max(t_bytes, t_tc),
                   k7_bound_by="bytes" if t_bytes >= t_tc else "operations",
                   k7_library_ms=None)  # no single PyTorch call computes it
        timings.append(row)
        print("timing " + json.dumps(row), flush=True)
    return err, fwd_err, timings


def gmm_inputs(case, dtype, dev, seed=0):
    """xs (C·R, K), rhs (as the case lays it out) and group_sizes (C, G) of a
    K6 case, on the card; the path's sizes drawn with numpy from ``seed``."""
    import torch

    name, c, r, k, n, g, layout, sizes = case
    if sizes == "path":
        rng = np.random.default_rng(seed)
        sizes = [rng.multinomial(r, np.full(384, 1 / 384))[:g].tolist() for _ in range(c)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn(c * r, k, generator=gen, device=dev).to(dtype)
    if layout == "transposed":
        rhs = torch.randn(c, g, n, k, generator=gen, device=dev).to(dtype).transpose(-1, -2)
    else:
        rhs = torch.randn(c, g, k, n, generator=gen, device=dev).to(dtype)
        if layout == "shared":
            rhs = rhs[0]
    return xs, rhs, torch.tensor(sizes, dtype=torch.int32, device=dev)


def gmm_work(case, sizes, itemsize: int):
    """(bytes, flops) K6 must spend on a case: the rows in groups read once,
    the weights of every (client, expert) with a row read once (shared
    weights once for all clients), every output row written once (0 past the
    last group), the sizes read; 2·K·N flops per row in a group."""
    _, c, r, k, n, g, layout, _ = case
    s = np.asarray(sizes.cpu())
    rows = int(s.sum())
    mats = int((s.sum(0) > 0).sum()) if layout == "shared" else int((s > 0).sum())
    nbytes = (rows * k + mats * k * n + c * r * n) * itemsize + 4 * s.size
    return nbytes, 2 * rows * k * n


def grouped_mm_yardstick(xs, rhs, sizes, want):
    """torch._grouped_mm on K6's rows in groups and weights, where torch has
    it: (callable, its largest gap to K6's rows), or (None, reason). Never
    on the port's path."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None, "torch has no _grouped_mm"
    c, g = sizes.shape
    r = xs.shape[0] // c
    in_group = (torch.arange(r, device=xs.device)[None, :] < sizes.sum(1, keepdim=True)).reshape(-1)
    rows = xs[in_group].contiguous()
    mats = (rhs.expand(c, *rhs.shape) if rhs.dim() == 3 else rhs).reshape(c * g, *rhs.shape[-2:])
    mats = mats.contiguous()
    offs = torch.cumsum(sizes.reshape(-1), 0).to(torch.int32)
    try:
        fn = lambda: torch._grouped_mm(rows, mats, offs=offs)
        gap = float((fn().float() - want[in_group].float()).abs().max())
    except Exception as exc:   # a yardstick only: record why it did not run
        return None, f"{type(exc).__name__}: {str(exc)[:200]}"
    return fn, gap


def phase_gmm(dev):
    """Phase 2, K6: every case against the plain version, then the timings.
    Returns K6's largest error and the rows."""
    import torch
    from repro_torch.kernels import moe_gmm as tgmm

    err = 0.0
    ncases = 0
    for case in GMM_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and case[0] not in GMM_F32:
                continue
            xs, rhs, sizes = gmm_inputs(case, dtype, dev)
            got = tgmm.grouped_matmul_fwd(xs, rhs, sizes)
            want = tgmm.gmm_plain_clients(xs, rhs, sizes)
            where = f"K6 {case[0]} {dtype}"
            if not torch.equal((got == 0).all(1), (want == 0).all(1)):
                raise AssertionError(f"{where}: the rows that are 0 differ")
            top = float(want.float().abs().max())
            if dtype == torch.bfloat16:
                e = check_within_bf16_ulp(where, got, want, atol=1e-5 * top)
            else:
                e = check_close(where, got, want, atol=1e-5 * top)
            err = max(err, e)
            ncases += 1
    torch.cuda.synchronize()
    print(f"phase 2: {ncases} K6 cases, kernel == plain (zero rows equal; bf16 within 1 ulp "
          f"+ 1e-5 of the max, f32 rtol {RTOL} + 1e-5 of the max); max abs err {err:.3e}",
          flush=True)

    timings = []
    for case in (c for c in GMM_CASES if c[0] in GMM_TIMED):
        xs, rhs, sizes = gmm_inputs(case, torch.bfloat16, dev, seed=1)
        kern = lambda: tgmm.grouped_matmul_fwd(xs, rhs, sizes)
        plain = lambda: tgmm.gmm_plain_clients(xs, rhs, sizes)
        s = sizes.cpu().numpy()
        row = {"case": case[0], "kernel": "gmm_bf16_kernel", "C": case[1], "R": case[2],
               "K": case[3], "N": case[4],
               "G": case[5], "rhs": case[6], "rows_in_groups": int(s.sum()),
               "max_group": int(s.max())}
        row["k6_ms"] = time_ms(kern, 20)
        row["k6_plain_ms"] = time_ms(plain, 3)
        row["k6_device_ms"] = device_ms(kern, "gmm_bf16_kernel")
        row["k6_plain_device_ms"] = device_ms(plain, None, iters=3)
        lib, note = grouped_mm_yardstick(xs, rhs, sizes, kern())
        if lib is None:
            row.update(k6_library_ms=None, k6_library_note=note)
        else:
            row.update(k6_library_ms=time_ms(lib, 20),
                       k6_library_device_ms=device_ms(lib, None),
                       library_max_abs_diff=note)
        nbytes, flops = gmm_work(case, sizes, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        row.update(bytes=nbytes, flops=flops, k6_bound_ms=max(t_bytes, t_ops),
                   k6_bound_by="bytes" if t_bytes >= t_ops else "operations")
        timings.append(row)
        print("timing " + json.dumps(row), flush=True)
    return err, timings


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import moe_gmm as tgmm
    from repro_torch.kernels import score_select as tss
    from repro_torch.kernels import ssd_scan as tssd

    return {**tss.LAUNCHES, **tss.SHARDED_LAUNCHES, **tfa.LAUNCHES, **tgmm.LAUNCHES,
            **tssd.LAUNCHES}


def reset_launch_counts() -> None:
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import moe_gmm as tgmm
    from repro_torch.kernels import score_select as tss
    from repro_torch.kernels import ssd_scan as tssd

    for module in (tss, tfa, tgmm, tssd):
        module.reset_launches()


def phase_main_path(dev):
    """Phase 3: Algorithm 1 on full-width ResNet-18 through the kernels."""
    import torch
    from repro_torch.configs import FedConfig, get_config
    from repro_torch.core.scoring import HeteRoScoreConfig
    from repro_torch.core.selection import (SelectorConfig, dynamic_temperature,
                                            gumbel_noise)
    from repro_torch.core.state import score_inputs
    from repro_torch.data import make_vision_data
    from repro_torch.fed import RoundHook, run_federated
    from repro_torch.kernels import score_select as tss
    from repro_torch.models import build_model

    fed = FedConfig(num_clients=12, participation=0.5, rounds=3, local_batch=32,
                    lr=0.01, mu=0.1, dirichlet_alpha=0.1, seed=0)
    m = fed.num_selected
    data = make_vision_data(fed)
    model = build_model(get_config("resnet18-cifar10"))
    n_params = sum(math.prod(p.shape) for p in model.module.parameters())

    noise_gen = torch.Generator(device=dev).manual_seed(fed.seed)
    drawn = {}

    def noise(t, k):
        if t not in drawn:
            drawn[t] = gumbel_noise(noise_gen, k)
        return drawn[t]

    class CheckRound(RoundHook):
        """Per round: the cohort equals the plain versions' selection on the
        same state and noise, and each kernel launched exactly once."""

        def on_round_start(self, ctx):
            t = ctx.round_idx
            eng = ctx.engine
            sel, _, _ = tss.fused_score_select_plain(
                *score_inputs(eng.state), round_idx=t,
                tau=dynamic_temperature(t, SelectorConfig(num_selected=m)),
                m=m, gumbel=eng.round_noise(t), cfg=HeteRoScoreConfig())
            self.expected = np.zeros(fed.num_clients, bool)
            self.expected[sel.cpu().numpy()] = True
            self.before = dict(tss.LAUNCHES)

        def on_round_end(self, ctx):
            grew = {n: tss.LAUNCHES[n] - self.before[n] for n in tss.LAUNCHES}
            if grew != {"score_stats": 1, "score_select": 1, "score_probs": 0,
                        "segment_probs": 0}:
                raise AssertionError(f"round {ctx.round_idx}: launches {grew}")
            if not np.array_equal(ctx.mask, self.expected):
                raise AssertionError(
                    f"round {ctx.round_idx}: cohort {np.flatnonzero(ctx.mask)} != "
                    f"plain selection {np.flatnonzero(self.expected)}")
            print(f"round {ctx.round_idx}: cohort {np.flatnonzero(ctx.mask).tolist()} "
                  f"== plain; train_loss {ctx.train_loss:.4f} "
                  f"{ctx.engine.metric_name} {ctx.metric:.4f}", flush=True)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_federated(model, fed, data, selector="heterosel_pallas",
                        steps_per_round=4, client_execution="batched",
                        device=dev, noise=noise, hooks=[CheckRound()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()

    if launches != {"score_stats": fed.rounds, "score_select": fed.rounds,
                    "score_probs": 0, "segment_probs": 0, "sharded_score_select": 0,
                    "flash_attention": 0, "grouped_matmul": 0, "ssd_chunk": 0}:
        raise AssertionError(f"main path launches {launches}, want {fed.rounds} "
                             "of K1 and K2")
    if not np.all(np.isfinite(res.train_loss)):
        raise AssertionError(f"non-finite train loss {res.train_loss}")
    for name, p in res.params.items():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"non-finite parameter {name}")
    if res.selected_history.shape != (fed.rounds, fed.num_clients) \
            or not np.all(res.selected_history.sum(1) == m):
        raise AssertionError(f"bad selection history {res.selected_history}")
    print(f"phase 3: resnet18-cifar10 ({n_params} params), K={fed.num_clients} "
          f"m={m}, {fed.rounds} rounds x 4 steps x batch {fed.local_batch}, "
          f"wall {wall:.2f} s", flush=True)
    for t in range(fed.rounds):
        print(f"  round {t}: select_ms {res.select_ms[t]:.3f}  execute_ms "
              f"{res.execute_ms[t]:.3f}  aggregate_ms {res.aggregate_ms[t]:.3f}",
              flush=True)
    print(f"  summary {json.dumps(res.summary())}", flush=True)
    print(f"  train_loss {res.train_loss.tolist()}", flush=True)
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated(dev)} bytes",
          flush=True)
    print(f"  launches {json.dumps(launches)}", flush=True)
    return launches


def phase_hierarchy(dev, err: dict):
    """Phase 4: hierarchical sync rounds on full-width ResNet-18 through K4;
    K4's largest error against its plain version goes into ``err``."""
    import torch
    from repro_torch.configs import FedConfig, get_config
    from repro_torch.core.selection import gumbel_noise
    from repro_torch.data import make_vision_data
    from repro_torch.fed import HierarchyConfig, RoundHook, run_federated
    from repro_torch.kernels import score_select as tss
    from repro_torch.models import build_model

    fed = FedConfig(num_clients=24, participation=0.5, rounds=3, local_batch=32,
                    lr=0.01, mu=0.1, dirichlet_alpha=0.1, seed=0,
                    topology="hierarchical", edge_count=4)
    hcfg = HierarchyConfig(edges_per_round=3)
    want_selected = 9   # 3 edges × budget 3
    data = make_vision_data(fed)
    model = build_model(get_config("resnet18-cifar10"))

    noise_gen = torch.Generator(device=dev).manual_seed(fed.seed)
    drawn = {}

    def edge_noise(t, stream, n):
        if (t, stream) not in drawn:
            drawn[t, stream] = gumbel_noise(noise_gen, n)
        return drawn[t, stream]

    class CheckRound(RoundHook):
        """Per round: K4's probs and scores equal its plain version's on the
        same edge-major state (rtol 1e-5, padding 0.0), the cohort equals the
        plain selection on that state and noise (the outer stage has no
        kernel), and K4 launched exactly once."""

        def __init__(self):
            self.max_abs_err = 0.0

        def on_round_start(self, ctx):
            t, eng = ctx.round_idx, ctx.engine
            picks = eng.select_round(t, scorer=tss.segmented_score_probs_plain)
            self.plain_out = eng.segment_out
            self.expected = np.zeros(fed.num_clients, bool)
            for _, members in picks:
                self.expected[members] = True
            self.before = dict(tss.LAUNCHES)

        def on_round_end(self, ctx):
            t, eng = ctx.round_idx, ctx.engine
            grew = {n: tss.LAUNCHES[n] - self.before[n] for n in tss.LAUNCHES}
            if grew != {"score_stats": 0, "score_select": 0, "score_probs": 0,
                        "segment_probs": 1}:
                raise AssertionError(f"round {t}: launches {grew}")
            (probs_k, scores_k), (probs_p, scores_p) = eng.segment_out, self.plain_out
            err = max(check_close(f"round {t} K4 scores", scores_k, scores_p, atol=1e-6),
                      check_close(f"round {t} K4 probs", probs_k, probs_p, atol=1e-30))
            sizes = torch.as_tensor(eng.partition.sizes, device=dev)
            seg = probs_k.numel() // len(sizes)
            pad = (torch.arange(seg, device=dev)[None, :] >= sizes[:, None]).reshape(-1)
            if bool((probs_k[pad] != 0).any()) or bool((scores_k[pad] != 0).any()):
                raise AssertionError(f"round {t}: a K4 padding slot is not 0.0")
            self.max_abs_err = max(self.max_abs_err, err)
            if eng.cloud_uploads[-1] != hcfg.edges_per_round:
                raise AssertionError(f"round {t}: {eng.cloud_uploads[-1]} uploads")
            if int(ctx.mask.sum()) != want_selected:
                raise AssertionError(f"round {t}: {int(ctx.mask.sum())} selected")
            if not np.array_equal(ctx.mask, self.expected):
                raise AssertionError(
                    f"round {t}: cohort {np.flatnonzero(ctx.mask)} != plain "
                    f"selection {np.flatnonzero(self.expected)}")
            print(f"round {t}: K4 == plain (max abs err {err:.3e}); cohort "
                  f"{np.flatnonzero(ctx.mask).tolist()} == plain; train_loss "
                  f"{ctx.train_loss:.4f} {eng.metric_name} {ctx.metric:.4f}", flush=True)

    check = CheckRound()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_federated(model, fed, data, selector="heterosel_pallas",
                        steps_per_round=4, client_execution="batched", device=dev,
                        hier_cfg=hcfg, edge_noise=edge_noise, hooks=[check])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()

    if launches != {"score_stats": 0, "score_select": 0, "score_probs": 0,
                    "segment_probs": fed.rounds, "sharded_score_select": 0,
                    "flash_attention": 0, "grouped_matmul": 0, "ssd_chunk": 0}:
        raise AssertionError(f"hierarchical path launches {launches}, want "
                             f"{fed.rounds} of K4 and nothing else")
    if not np.all(np.isfinite(res.train_loss)):
        raise AssertionError(f"non-finite train loss {res.train_loss}")
    for name, p in res.params.items():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"non-finite parameter {name}")
    if res.selected_history.shape != (fed.rounds, fed.num_clients) \
            or not np.all(res.selected_history.sum(1) == want_selected) \
            or not np.all(res.cloud_uploads == hcfg.edges_per_round):
        raise AssertionError(f"bad history {res.selected_history} / uploads "
                             f"{res.cloud_uploads}")
    print(f"phase 4: hierarchical resnet18-cifar10, K={fed.num_clients} "
          f"E={fed.edge_count} ({hcfg.edges_per_round} per round, budgets 3), "
          f"{fed.rounds} rounds x 4 steps x batch {fed.local_batch}, wall {wall:.2f} s",
          flush=True)
    for t in range(fed.rounds):
        print(f"  round {t}: select_ms {res.select_ms[t]:.3f}  execute_ms "
              f"{res.execute_ms[t]:.3f}  aggregate_ms {res.aggregate_ms[t]:.3f}  "
              f"cloud_uploads {res.cloud_uploads[t]}", flush=True)
    print(f"  summary {json.dumps(res.summary())}", flush=True)
    print(f"  train_loss {res.train_loss.tolist()}", flush=True)
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated(dev)} bytes",
          flush=True)
    print(f"  launches {json.dumps(launches)}", flush=True)
    err["segment_probs"] = max(err["segment_probs"], check.max_abs_err)
    return launches


def ssd_chunk_plain_f64(x, dt, a_neg, b, c):
    """K7's plain version computed in f64 and rounded to f32: the same
    function with other rounding, for measuring how far the model carries a
    last-bits change of the SSD's output."""
    from repro_torch.kernels import ssd_scan as tssd

    out = tssd.ssd_chunk_plain(*(t.double() for t in (x, dt, a_neg, b, c)))
    return tuple(o.float() for o in out)


def gmm_plain_f64(xs, rhs, group_sizes, *, block_m):
    """K6's plain version summed in f64 and rounded once to xs's dtype, client
    by client as ``gmm_plain_clients``: the same function with other
    rounding (the floor of phase 7's eval check)."""
    import torch
    from repro_torch.kernels import moe_gmm as tgmm

    sizes = group_sizes.reshape(-1, rhs.shape[-3])
    rows = xs.shape[0] // sizes.shape[0]
    return torch.cat([
        tgmm.gmm_plain(xs[c * rows:(c + 1) * rows].double(),
                       (rhs[c] if rhs.dim() == 4 else rhs).double(), sizes[c],
                       block_m=block_m).to(xs.dtype) for c in range(sizes.shape[0])])


@contextlib.contextmanager
def plain_version(kernel: str, plain=None):
    """Within this block the named kernel's autograd.Function takes its plain
    version (or ``plain``) on the card too: for holding a forward through the
    kernel against the same forward without it. The port's own path never
    does this."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import moe_gmm as tgmm
    from repro_torch.kernels import ssd_scan as tssd

    module, attr, default = {
        "flash_attention": (tfa, "flash_attention_fwd", tfa.flash_attention_plain),
        "grouped_matmul": (tgmm, "grouped_matmul_fwd", tgmm.gmm_plain_clients),
        "ssd_chunk": (tssd, "ssd_chunk", tssd.ssd_chunk_plain)}[kernel]
    plain = plain or default
    saved = getattr(module, attr)
    setattr(module, attr, plain)
    try:
        yield
    finally:
        setattr(module, attr, saved)


def phase_lm(dev, phase: int, cfg, seq_len: int, per_layer: dict, kernel: str,
             plain_f64=None):
    """Phases 5–7: the federated LM path on the full-width ``cfg`` through
    K1, K2 and the model's own kernels (K5 for qwen2, K7 for mamba2, K5 and
    K6 for the kimi-k2 share), ``per_layer`` launches of each per layer per
    round; returns the path's launch counts and the eval logits' largest gap
    between ``kernel`` and its plain version. With ``plain_f64`` (the plain
    version with other rounding) the allowed gap is at least twice the gap
    that opens between it and the plain version."""
    import torch
    from repro_torch.configs import FedConfig
    from repro_torch.core.scoring import HeteRoScoreConfig
    from repro_torch.core.selection import (SelectorConfig, dynamic_temperature,
                                            gumbel_noise)
    from repro_torch.core.state import score_inputs
    from repro_torch.data import make_lm_data
    from repro_torch.fed import FederatedSpec, RoundHook
    from repro_torch.fed.engine import default_eval
    from repro_torch.kernels import score_select as tss
    from repro_torch.models import build_model

    arch = cfg.name
    fed = FedConfig(num_clients=8, participation=0.5, rounds=LM_ROUNDS, local_epochs=1,
                    local_batch=8, lr=0.05, mu=0.1, seed=0)
    m = fed.num_selected
    data = make_lm_data(fed, vocab=cfg.vocab_size, seq_len=seq_len)
    model = build_model(cfg)
    n_params = sum(math.prod(p.shape) for p in model.module.parameters())
    want_round = {n: 0 for n in launch_counts()}
    want_round.update(score_stats=1, score_select=1,
                      **{k: cfg.num_layers * c for k, c in per_layer.items()})
    print(f"phase {phase}: {arch}, {n_params} params, seq {seq_len}, predicted launches "
          f"per round " + ", ".join(f"{k} {cfg.num_layers} x {c} = {cfg.num_layers * c}"
                                    for k, c in per_layer.items()), flush=True)

    noise_gen = torch.Generator(device=dev).manual_seed(fed.seed)
    drawn = {}

    def noise(t, k):
        if t not in drawn:
            drawn[t] = gumbel_noise(noise_gen, k)
        return drawn[t]

    class CheckRound(RoundHook):
        """Per round: the cohort equals the plain versions' selection on the
        same state and noise; K1 and K2 launched once, the model's kernel
        per_round times, nothing else."""

        def on_round_start(self, ctx):
            t, eng = ctx.round_idx, ctx.engine
            sel, _, _ = tss.fused_score_select_plain(
                *score_inputs(eng.state), round_idx=t,
                tau=dynamic_temperature(t, SelectorConfig(num_selected=m)),
                m=m, gumbel=eng.round_noise(t), cfg=HeteRoScoreConfig())
            self.expected = np.zeros(fed.num_clients, bool)
            self.expected[sel.cpu().numpy()] = True
            self.before = launch_counts()

        def on_round_end(self, ctx):
            now = launch_counts()
            grew = {n: now[n] - self.before[n] for n in now}
            if grew != want_round:
                raise AssertionError(f"round {ctx.round_idx}: launches {grew}, "
                                     f"want {want_round}")
            if not np.array_equal(ctx.mask, self.expected):
                raise AssertionError(
                    f"round {ctx.round_idx}: cohort {np.flatnonzero(ctx.mask)} != "
                    f"plain selection {np.flatnonzero(self.expected)}")
            print(f"round {ctx.round_idx}: cohort {np.flatnonzero(ctx.mask).tolist()} "
                  f"== plain; launches {json.dumps(grew)}; train_loss "
                  f"{ctx.train_loss:.6f} {ctx.engine.metric_name} {ctx.metric:.6e}",
                  flush=True)

    engine = FederatedSpec(model, fed, data, selector="heterosel_pallas",
                           steps_per_round=LM_STEPS, executor="batched", device=dev,
                           noise=noise, hooks=[CheckRound()]).build()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    want = {n: c * fed.rounds for n, c in want_round.items()}
    if launches != want:
        raise AssertionError(f"{arch} path launches {launches}, want {want}")
    if not np.all(np.isfinite(res.train_loss)):
        raise AssertionError(f"non-finite train loss {res.train_loss}")
    if res.metric_name != "exp(-loss)" or not np.all((res.accuracy > 0) & (res.accuracy <= 1)):
        raise AssertionError(f"bad eval {res.metric_name} {res.accuracy}")
    for name, p in res.params.items():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"non-finite parameter {name}")
    if res.selected_history.shape != (fed.rounds, fed.num_clients) \
            or not np.all(res.selected_history.sum(1) == m):
        raise AssertionError(f"bad selection history {res.selected_history}")

    # One eval forward through the kernel against the same forward through its
    # plain version, on the trained params; the loss to 1e-3 relative. The
    # bf16 layers carry a 1-ulp rounding difference of one activation onward.
    # K5 (24 layers): logits within 4 bf16 ulp of the largest (on the CPU,
    # reordering K5's plain sums moved qwen2 logits by 1.3 ulp). K7 (48
    # layers) and K6: within 4 ulp or twice the floor, the gap that the plain
    # version computed in f64 (a rounding-level change of the same function)
    # opens against the plain version.
    batch = {k: v.to(dev) for k, v in data.eval_batch().items()}

    def eval_logits(*plain):
        """Logits and loss through the kernel, or with ``plain_version(kernel,
        *plain)`` when ``plain`` is given (``None``: the plain version)."""
        with torch.no_grad(), contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_version(kernel, *plain))
            logits = model.forward(res.params, batch)[..., :cfg.vocab_size].float()
            return logits, float(model.loss(res.params, batch))

    logits_k, loss_k = eval_logits()
    logits_p, loss_p = eval_logits(None)
    gap = float((logits_k - logits_p).abs().max())
    top = float(bf16_ulp(logits_p.abs().max()))
    allowed, floor = 4 * top, None
    if plain_f64 is not None:
        floor = float((eval_logits(plain_f64)[0] - logits_p).abs().max())
        allowed = max(allowed, 2 * floor)
    if not gap <= allowed or abs(loss_k - loss_p) > 1e-3 * abs(loss_p):
        raise AssertionError(f"eval logits through {kernel} vs plain: max gap {gap:.3e} "
                             f"(bf16 ulp of the top logit {top:.3e}, floor {floor}), "
                             f"loss {loss_k} vs {loss_p}")
    print(f"phase {phase}: K=8 m={m}, {fed.rounds} rounds x {LM_STEPS} steps x batch "
          f"{fed.local_batch} x seq {seq_len}, wall {wall:.2f} s", flush=True)
    for t in range(fed.rounds):
        print(f"  round {t}: select_ms {res.select_ms[t]:.3f}  execute_ms "
              f"{res.execute_ms[t]:.3f}  aggregate_ms {res.aggregate_ms[t]:.3f}  "
              f"eval_ms {res.eval_ms[t]:.3f}  exp(-loss) {res.accuracy[t]:.6e}", flush=True)
    print(f"  eval logits {kernel} vs plain: max abs gap {gap:.4e} ({gap / top:.2f} bf16 "
          f"ulp of the top logit), loss {loss_k:.6f} vs {loss_p:.6f}"
          + (f"; floor (plain f64 vs plain f32) {floor:.4e} ({floor / top:.2f} ulp)"
             if floor is not None else ""), flush=True)
    print(f"  labeled_summary {json.dumps(res.labeled_summary())}", flush=True)
    print(f"  train_loss {res.train_loss.tolist()}", flush=True)
    print(f"  params {n_params}  max_memory_allocated {peak} bytes"
          + (f"  ({cfg.expert_deployment})" if cfg.family == "moe" else ""), flush=True)
    before, before_seq = PEAK_BEFORE[phase]
    print(f"  peak memory {peak} bytes at seq {seq_len}; before the visit kept no "
          f"backward graph and one f32 delta at a time: {before} bytes at seq "
          f"{before_seq} ({peak / before:.3f}x)", flush=True)
    print(f"  launches {json.dumps(launches)}", flush=True)

    # Where the time goes, outside the counted run: one more cohort call (the
    # last round's cohort, on the trained params) and one more eval, each
    # under torch.profiler. Busy = the sum of the CUDA kernels' device time;
    # idle share = 1 - busy / host wall time.
    cohort = np.flatnonzero(res.selected_history[-1])
    for what, fn in (
            ("execute", lambda: engine.executor.run_round(
                engine.params, cohort, np.random.default_rng(fed.seed))),
            ("eval", lambda: default_eval(model, engine.params, batch))):
        prof = profile_phase(fn)
        if what == "execute":
            prof["kernel_launches_per_local_step"] = prof["kernel_launches"] / LM_STEPS
        print(f"  profile {what}: " + json.dumps(prof), flush=True)
    return launches, gap


def release(dev) -> None:
    """Free what the last phase left cached, so each path's peak is its own."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def profile_phase(fn, top: int = 10) -> dict:
    """Host wall time of ``fn`` under torch.profiler, the device time its
    CUDA kernels took, the idle share, and the operators whose kernels took
    the most device time ([name, calls, device ms])."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # Kernel events carry the device time; CPU operator events carry the
    # same time again (that of the kernels they launched), so count once.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall if wall else None,
            "kernel_launches": sum(e.count for e in kernels),
            "top_ops": [[e.key[:40], e.count, e.self_device_time_total / 1e3]
                        for e in ops[:top]]}


def phase_k8_offsets(dev) -> float:
    """Phase 2, K8's offset: K = 2^20 split into K8_WORLD client shards of
    this process, f32 and bf16 state. K1 and K2 run on each shard with its
    global offset and limit and are held against their plain versions with
    the same offset (candidate ids exactly); then the shards are merged by
    the collectives' arithmetic on local tensors
    (``sharded_score_select_in_process``), and the merge must select the
    single-device fused cohort. Returns the largest error."""
    import torch
    from repro_torch.core.scoring import HeteRoScoreConfig
    from repro_torch.core.selection import SelectorConfig, dynamic_temperature
    from repro_torch.kernels import score_select as tss

    cfg = HeteRoScoreConfig()
    t = 9
    tau = dynamic_temperature(t, SelectorConfig())
    (k, m), world = K8_CHECK, K8_WORLD
    _, blk, _, _ = tss.shard_layout(k, world)
    t_f, tau_f, decay = tss._scalars(t, tau, cfg)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(k + world)
        rows = random_rows(k, dtype, gen, t)
        gumbel = -torch.log(-torch.log(
            torch.rand(k, generator=gen, device=dev).clamp_min(1e-38)))
        for rank in range(world):
            stacked, gpad, off, klim = tss.shard_operands(rows, gumbel, None, rank=rank,
                                                          world=world)
            where = f"K8 shard {rank} (off {off}, klim {klim}) {dtype}"
            stats_k = tss.score_stats(stacked, k=klim, block=blk, off=off)
            stats_p = tss.score_stats_plain(stacked, k=klim, block=blk, off=off)
            err = max(err, check_close(f"{where} K1", stats_k, stats_p))
            glob = tss._combine_stats(stats_p)
            kw = dict(k=klim, block=blk, off=off, t=t_f, tau=tau_f, use_ov=False,
                      decay=decay, cfg=cfg, mb=min(m, blk))
            out_k = tss.score_select(stacked, glob, gpad, **kw)
            out_p = tss.score_select_plain(stacked, glob, gpad, **kw)
            err = max(err, check_close(f"{where} K2 scores", out_k[0], out_p[0], atol=1e-6),
                      check_close(f"{where} K2 exp", out_k[1], out_p[1], atol=1e-30),
                      check_close(f"{where} K2 (m_b, l_b)", out_k[2], out_p[2]),
                      check_close(f"{where} K2 candidates", out_k[3], out_p[3], atol=1e-6))
            if not torch.equal(out_k[4], out_p[4]):
                raise AssertionError(f"{where}: candidate ids differ from the plain version")
        kw = dict(round_idx=t, tau=tau, m=m, gumbel=gumbel, cfg=cfg)
        sel_s, probs_s, scores_s = tss.sharded_score_select_in_process(*rows, world=world,
                                                                       **kw)
        sel_f, probs_f, scores_f = tss.fused_score_select(*rows, **kw)
        if set(sel_s.tolist()) != set(sel_f.tolist()):
            raise AssertionError(f"K8 W={world} in one process, {dtype}: the merged cohort "
                                 "is not the single-device cohort")
        check_close(f"K8 W={world} {dtype} probs", probs_s, probs_f, atol=1e-30)
        check_close(f"K8 W={world} {dtype} scores", scores_s, scores_f, atol=1e-6)
    torch.cuda.synchronize()
    print(f"phase 2: K8 offsets, K={k} in {world} shards, f32 and bf16: K1 and K2 with "
          f"each shard's offset == plain (rtol {RTOL}, candidate ids exact), max abs err "
          f"{err:.3e}; the in-process merge selects the single-device cohort", flush=True)
    return err


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def k8_work(k: int, itemsize: int, m: int) -> int:
    """Bytes K8's function must move for K clients: each input read once (the
    8 state rows and the f32 Gumbel row) and each output written once (probs
    and scores in f32, the m int32 ids). K1's second pass over 4 rows, K2's
    intermediates and the candidates are the design's choice, not the
    function's, and are not counted; on one rank no collective moves bytes."""
    return 8 * k * itemsize + 4 * k + 2 * 4 * k + 4 * m


def phase_table8(dev):
    """Phase 8: the selection control plane at population scale, the
    reference's Table 8 (``benchmarks/table8_selector.py``). For each K in
    TABLE8_KS, m = max(round(10^-3·K), 1), round 7, the port's copy of the
    table's bf16 state (``data.synthetic_client_state``) and one Gumbel row,
    three methods select a cohort: ``heterosel`` unfused
    (``compute_scores`` → ``selection_probabilities`` →
    ``sample_clients``), fused (``ops.heterosel_topm``, K1 + K2) and sharded
    (``ops.heterosel_topm_sharded``, K8 on a one-rank NCCL group made
    here). Launch counts are zeroed before the three run once at each K and
    read after; the fused and sharded cohorts, probs and scores must be
    bitwise equal, the sharded ones equal to K8's plain version (the cohort
    as a set, probs and scores within RTOL), and all three cohorts equal as
    sets (the table's own
    acceptance); where the unfused cohort differs, the gap between the m-th
    and (m+1)-th perturbed values must be within f32 rounding. Then each
    (K, method) is timed."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.scoring import HeteRoScoreConfig
    from repro_torch.core.selection import (SelectorConfig, dynamic_temperature,
                                            gumbel_noise, make_selector)
    from repro_torch.core.state import score_inputs, to_bf16
    from repro_torch.data import synthetic_client_state
    from repro_torch.kernels import ops
    from repro_torch.kernels import score_select as tss

    cfg = HeteRoScoreConfig()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        group = dist.group.WORLD
        if dist.get_backend(group) != "nccl":
            raise AssertionError(f"K8's group is {dist.get_backend(group)}, not nccl")
        cases = []
        for k in TABLE8_KS:
            m = max(int(round(1e-3 * k)), 1)
            sel_cfg = SelectorConfig(num_selected=m)
            tau = dynamic_temperature(TABLE8_ROUND, sel_cfg)
            state = to_bf16(synthetic_client_state(k, seed=0, device=dev))
            gumbel = gumbel_noise(torch.Generator(device=dev).manual_seed(k), k)
            unfused = make_selector("heterosel", sel_cfg, cfg)
            cases.append((k, m, state, gumbel, {
                "unfused": lambda u=unfused, s=state, g=gumbel: u(g, s, TABLE8_ROUND),
                "fused": lambda s=state, g=gumbel, tau=tau, m=m: ops.heterosel_topm(
                    s, TABLE8_ROUND, tau, m, g, cfg),
                "sharded": lambda s=state, g=gumbel, tau=tau, m=m: ops.heterosel_topm_sharded(
                    s, TABLE8_ROUND, tau, m, g, cfg, group=group)}))
        torch.cuda.synchronize()
        reset_launch_counts()
        outs = [{name: fn() for name, fn in methods.items()} for *_, methods in cases]
        torch.cuda.synchronize()
        launches = launch_counts()
        want = {n: 0 for n in launches}
        want.update(score_stats=2 * len(cases), score_select=2 * len(cases),
                    sharded_score_select=len(cases))
        if launches != want:
            raise AssertionError(f"Table 8 path launches {launches}, want {want}")

        rows = []
        for (k, m, state, gumbel, methods), out in zip(cases, outs):
            mask_u, probs_u = out["unfused"]
            sel_f, probs_f, scores_f = out["fused"]
            sel_s, probs_s, scores_s = out["sharded"]
            for what, a, b in (("cohort", sel_f, sel_s), ("probs", probs_f, probs_s),
                               ("scores", scores_f, scores_s)):
                if not torch.equal(a, b):
                    raise AssertionError(f"K={k}: sharded {what} differ from fused")
            set_u = set(torch.nonzero(mask_u).flatten().tolist())
            set_f = set(sel_f.tolist())
            pert = torch.log(probs_u + 1e-30) + gumbel
            top = torch.sort(pert, descending=True).values
            gap = float(top[m - 1] - top[m])
            rounding = 16 * torch.finfo(torch.float32).eps * max(
                1.0, abs(float(top[m - 1])), abs(float(top[m])))
            if set_u != set_f and gap > rounding:
                raise AssertionError(
                    f"K={k}: unfused and fused cohorts differ by {len(set_u ^ set_f)} "
                    f"clients with a boundary gap {gap:.3e} over f32 rounding {rounding:.3e}")
            check_close(f"K={k} unfused vs fused probs", probs_f, probs_u, atol=1e-12)
            plain = lambda s=state, g=gumbel, m=m: tss.sharded_score_select_plain(
                *score_inputs(s), round_idx=TABLE8_ROUND,
                tau=dynamic_temperature(TABLE8_ROUND, SelectorConfig(num_selected=m)),
                m=m, gumbel=g, cfg=cfg, group=group)
            sel_p, probs_p, scores_p = plain()
            if set(sel_p.tolist()) != set(sel_s.tolist()):
                raise AssertionError(f"K={k}: K8's cohort is not its plain version's")
            err = max(check_close(f"K={k} K8 probs vs plain", probs_s, probs_p, atol=1e-30),
                      check_close(f"K={k} K8 scores vs plain", scores_s, scores_p, atol=1e-6))
            row = {"K": k, "m": m, "cohorts_equal": set_u == set_f,
                   "boundary_gap": gap, "f32_rounding": rounding, "sharded_vs_plain_err": err}
            iters = 100 if k <= 10_000 else 20
            for name, fn in methods.items():
                row[f"{name}_ms"] = time_ms(fn, iters)
                row[f"{name}_device_ms"] = device_ms(fn, None, iters=10)
            if k == TABLE8_KS[-1]:
                row["sharded_plain_ms"] = time_ms(plain, iters)
                row["sharded_plain_device_ms"] = device_ms(plain, None, iters=10)
                row["sharded_bound_ms"] = k8_work(k, 2, m) / HBM_BYTES_PER_S * 1e3
            rows.append(row)
            print("table8 " + json.dumps(row), flush=True)
    finally:
        dist.destroy_process_group()
    print(f"phase 8: Table 8 control plane, K {list(TABLE8_KS)}, bf16 state: fused == "
          f"sharded (one-rank NCCL) bitwise, sharded == its plain version (cohort, probs "
          f"and scores rtol {RTOL}), cohorts equal as sets; launches "
          f"{json.dumps(launches)}", flush=True)
    return launches, rows


def phase_table1(dev):
    """Phase 9: the paper's Table I comparison on full-width ResNet-18: the
    five selectors of ``repro_torch.examples.paper_reproduction`` on phase
    3's federation (K = 12, m = 6, batch 32, 4 local steps, lr 0.01, μ 0.1),
    flat, TABLE1_ROUNDS rounds, each selector on the same draws (one Gumbel
    row and one jitter row per round). No kernel runs on this path."""
    import torch
    from repro_torch.configs import FedConfig, get_config
    from repro_torch.core.selection import DRAW_NAMES, selector_draws
    from repro_torch.data import make_vision_data
    from repro_torch.examples.paper_reproduction import METHODS, run_methods
    from repro_torch.models import build_model

    fed = FedConfig(num_clients=12, participation=0.5, rounds=TABLE1_ROUNDS,
                    local_batch=32, lr=0.01, mu=0.1, dirichlet_alpha=0.1, seed=0)
    data = make_vision_data(fed)
    model = build_model(get_config("resnet18-cifar10"))
    gen = torch.Generator(device=dev).manual_seed(fed.seed)
    draws = [{n: DRAW_NAMES[n](gen, fed.num_clients) for n in ("gumbel", "jitter")}
             for _ in range(fed.rounds)]

    def noise(name):
        names = selector_draws(name)
        if names == ("gumbel",):
            return lambda t, k: draws[t]["gumbel"]
        return lambda t, k: {n: draws[t][n] for n in names}

    reset_launch_counts()
    t0 = time.perf_counter()
    results = run_methods(model, fed, data, device=dev, noise=noise)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"Table I path launched kernels {launches}")
    summaries = {}
    for name in METHODS:
        res = results[name]
        if not np.all(np.isfinite(res.train_loss)) or not all(
                bool(torch.isfinite(p).all()) for p in res.params.values()):
            raise AssertionError(f"{name}: non-finite loss or parameters")
        if res.selected_history.shape != (fed.rounds, fed.num_clients) \
                or not np.all(res.selected_history.sum(1) == fed.num_selected):
            raise AssertionError(f"{name}: bad selection history")
        summaries[name] = dict(
            res.labeled_summary(),
            select_ms_median=float(np.median(res.select_ms[1:])),
            execute_ms_median=float(np.median(res.execute_ms[1:])),
            eval_ms_median=float(np.median(res.eval_ms[1:])),
            selection_counts=res.selection_counts.tolist(),
            accuracy=res.accuracy.tolist())
        print(f"table1 {name} " + json.dumps(summaries[name]), flush=True)
    print(f"phase 9: Table I, {len(METHODS)} selectors x {fed.rounds} rounds on "
          f"resnet18-cifar10, K={fed.num_clients} m={fed.num_selected}, wall {wall:.2f} s; "
          "stability drop, lowest first: "
          f"{sorted(METHODS, key=lambda n: results[n].stability_drop)}", flush=True)
    return launches, summaries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.configs import expert_share, get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)

    t0 = time.perf_counter()
    sources = ("score_select", "flash_attention", "moe_gmm", "ssd_scan")
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc each, together
        builds = list(pool.map(_build.build, sources))
    for built in builds:
        print(f"phase 1: built {built.path.name} (nvcc {built.seconds:.2f} s)", flush=True)
        print(built.log.strip(), flush=True)
    print(f"phase 1: {len(builds)} libraries in {time.perf_counter() - t0:.2f} s", flush=True)
    # K5's, K6's and K7's kernels as ptxas placed them; their dynamic shared
    # memory is set per launch (csrc headers).
    for built, names in ((builds[1], ("flash_fwd_kernel_wgmma", "flash_fwd_kernel")),
                         (builds[2], ("gmm_bf16_kernel", "gmm_f32_kernel")),
                         (builds[3], ("ssd_chunk_cb_kernel", "ssd_chunk_heads_kernel"))):
        for row in ptxas_report(built.log, names):
            print("ptxas " + json.dumps(row), flush=True)
    # K7 runs its products on the tensor cores: every one of its kernels'
    # SASS must hold TF32 mma instructions.
    k7_sass = sass_tf32_mma(builds[3].path, ("ssd_chunk_cb_kernel", "ssd_chunk_heads_kernel"))
    print("sass " + json.dumps(k7_sass), flush=True)
    if len(k7_sass) < 2 or not all(k7_sass.values()):
        raise RuntimeError(f"K7 kernels without TF32 mma instructions in their SASS: {k7_sass}")

    err, timings = phase_kernels(dev)
    k8_err = phase_k8_offsets(dev)
    flash_err, flash_timings = phase_flash(dev)
    gmm_err, gmm_timings = phase_gmm(dev)
    ssd_err, ssd_fwd_err, ssd_timings = phase_ssd(dev)
    paths = {"flat": phase_main_path(dev), "hierarchical": phase_hierarchy(dev, err)}
    # Per layer per round: one launch per local step and one in the eval
    # (the vmap rules fold the cohort into one launch; K5's and K7's
    # backwards are plain PyTorch). K6: three grouped products per forward
    # and three dX products per backward (dW is plain PyTorch).
    per_layer = {"flash_attention": LM_STEPS + 1, "ssd_chunk": LM_STEPS + 1,
                 "grouped_matmul": LM_STEPS * (3 + 3) + 3}
    paths["lm"], lm_gap = phase_lm(dev, 5, get_config("qwen2-0.5b"), 32,
                                   {"flash_attention": per_layer["flash_attention"]},
                                   "flash_attention")
    release(dev)
    paths["ssm"], ssm_gap = phase_lm(dev, 6, get_config("mamba2-370m"), SSM_SEQ,
                                     {"ssd_chunk": per_layer["ssd_chunk"]}, "ssd_chunk",
                                     plain_f64=ssd_chunk_plain_f64)
    release(dev)
    paths["moe"], moe_gap = phase_lm(
        dev, 7, expert_share(get_config("kimi-k2-1t-a32b"), **MOE_SHARE), 32,
        {k: per_layer[k] for k in ("flash_attention", "grouped_matmul")}, "grouped_matmul",
        plain_f64=gmm_plain_f64)
    release(dev)
    paths["table8"], table8 = phase_table8(dev)
    paths["table1"], _ = phase_table1(dev)

    def launches(name):
        by_path = {p: counts[name] for p, counts in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    src = "src/repro_torch/kernels/csrc/score_select.cu"
    kernels = []
    # (name, timing key, reference kernel line, main-shape row): K1–K3 at the
    # flat path's K = 12, K4 at the hierarchical phase's K = 24, E = 4.
    for name, key, line, main_case in (
            ("score_stats", "k1", 105, {"K": 12}), ("score_select", "k2", 213, {"K": 12}),
            ("score_probs", "k3", 205, {"K": 12}),
            ("segment_probs", "k4", 233, {"case": "K=24 E=4"})):
        rows = [r for r in timings if f"{key}_ms" in r]
        main_row = next(r for r in rows if r["dtype"] == "float32"
                        and all(r.get(c) == v for c, v in main_case.items()))
        shape_keys = ("case", "E", "seg", "K", "dtype") if key == "k4" else ("K", "m", "dtype")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/score_select.py:{line}",
            **launches(name),
            "max_abs_err": err[name],
            "ms": main_row[f"{key}_ms"], "plain_ms": main_row[f"{key}_plain_ms"],
            "bound_ms": main_row[f"{key}_bound_ms"], "bound_by": "bytes",
            "library_ms": None,  # no single PyTorch call computes it
            "shapes": [{s: r[s] for s in shape_keys}
                       | {"ms": r[f"{key}_ms"], "plain_ms": r[f"{key}_plain_ms"],
                          "device_ms": r[f"{key}_device_ms"],
                          "plain_device_ms": r[f"{key}_plain_device_ms"],
                          "bound_ms": r[f"{key}_bound_ms"]} for r in rows],
        })
    main_row = next(r for r in flash_timings
                    if r["case"] == "path" and r["dtype"] == "bfloat16")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        **launches("flash_attention"),
        "max_abs_err": max(flash_err.values()),
        "max_abs_err_by_dtype": flash_err,
        "lm_eval_logit_gap": lm_gap,
        "ms": main_row["k5_ms"], "plain_ms": main_row["k5_plain_ms"],
        "bound_ms": main_row["k5_bound_ms"], "bound_by": main_row["k5_bound_by"],
        "library_ms": main_row["k5_library_ms"],   # scaled_dot_product_attention
        "shapes": flash_timings,
    })
    main_row = next(r for r in gmm_timings if r["case"] == "path gate")
    kernels.append({
        "name": "grouped_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:32",
        **launches("grouped_matmul"),
        "max_abs_err": gmm_err,
        "moe_eval_logit_gap": moe_gap,
        "ms": main_row["k6_ms"], "plain_ms": main_row["k6_plain_ms"],
        "bound_ms": main_row["k6_bound_ms"], "bound_by": main_row["k6_bound_by"],
        "library_ms": main_row["k6_library_ms"],   # torch._grouped_mm, where it exists
        "shapes": gmm_timings,
    })
    main_row = next(r for r in ssd_timings if r["case"] == "path")
    kernels.append({
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:24",
        **launches("ssd_chunk"),
        "max_abs_err": ssd_err,
        "ssd_forward_max_abs_err": ssd_fwd_err,
        "ssm_eval_logit_gap": ssm_gap,
        "sass_tf32_mma": k7_sass,
        "ms": main_row["k7_ms"], "device_ms": main_row["k7_device_ms"],
        "plain_ms": main_row["k7_plain_ms"],
        "bound_ms": main_row["k7_bound_ms"], "bound_by": main_row["k7_bound_by"],
        "bound_f32_ms": main_row["k7_bound_f32_ms"],
        "library_ms": None,  # no single PyTorch call computes it
        "shapes": ssd_timings,
    })
    main_row = table8[-1]   # K = 10^6, bf16 state, m = 1000
    kernels.append({
        "name": "sharded_score_select", "route": "cuda",
        "source": src,   # K1 and K2 with the shard's offset; collectives in score_select.py
        "replaces": "src/repro/kernels/score_select.py:448",
        **launches("sharded_score_select"),
        "max_abs_err": max([k8_err] + [r["sharded_vs_plain_err"] for r in table8]),
        "ms": main_row["sharded_ms"], "device_ms": main_row["sharded_device_ms"],
        "plain_ms": main_row["sharded_plain_ms"],
        "plain_device_ms": main_row["sharded_plain_device_ms"],
        "bound_ms": main_row["sharded_bound_ms"], "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes it
        "shapes": table8,
    })
    print(json.dumps({"kernels": kernels, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
