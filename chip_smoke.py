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
     and m ∈ {6, 64, 1024} (m ≤ K), K2's candidates (a radix select) bit
     for bit and the fused cohorts equal in order; K3 for the same K;
     K4 for the edge layouts in K4_CASES, padding slots exactly 0.0. Scores
     and probabilities must agree to 1e-5 relative. K5 for the cases in
     FLASH_CASES (f32 and bf16, causal and not, window 256, GQA 14/2 and
     MHA at D = 64, S = T ∈ {32, 1000, 4096}, D = 256, and kimi-k2's 64/8
     heads of D = 112; zamba2's 32 MHA heads of 112 at phase 10's shape,
     the vlm's cross-attention over 1601 keys at S 4096 and 32, hubert's
     16 MHA heads of 80 at 2 × 4096): f32 outputs to 1e-5 relative (1e-6 absolute), bf16
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
     (candidates bit for bit), and the shards merged by the collectives'
     arithmetic on local tensors, which must select the single-device
     fused cohort, in order: the only world size above 1 one card can
     check. Then
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
  6. The same federated LM setup on mamba2-370m at every width and 24 of its
     48 layers (SSM_LAYERS), at make_lm_data(seq_len=256) (see SSM_SEQ):
     each sequence one 256-row SSD chunk. Each round must launch K1 and K2
     once and K7 24 × (3 + 1) = 96 times, no K5, and select the plain
     versions' cohort; one eval forward through K7 is held against the same
     forward through K7's plain version.
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
     the same forward through K6's plain version. Phases 5 and 7 print their
     peak memory beside the one recorded before the client visit stopped
     keeping a graph of each backward and every leaf's f32 delta
     (PEAK_BEFORE).
  8. The selection control plane at population scale, the reference's Table
     8: K ∈ {10^3, 10^4, 10^5, 10^6}, m = K/1000, a bf16 client state; the
     unfused heterosel, the fused K1 + K2 and the sharded K8 on a one-rank
     NCCL group (made here) each select once at every K with the launch
     counts zeroed before and read after; fused and sharded bitwise equal,
     all three cohorts equal as sets; each timed (select_ms, device ms).
     K8's collective calls per call are counted (at most 4), and at K =
     10^6 the fused and K8 calls are broken down under torch.profiler by
     pack, K1, K2, statistics, normalizer, merge and all-gathers.
  9. The paper's Table I on full-width ResNet-18: its five selectors
     (heterosel, heterosel_mult, oort, power_of_choice, random) on phase 3's
     federation, flat, TABLE1_ROUNDS rounds, the same draws for each; each
     selector's peak, final, stability drop, select_ms and execute_ms.
 10. The federated LM path on zamba2-7b, the one model with K5 and K7 in one
     forward: every published width (d_model 3584, 32 MHA heads of 112, d_ff
     14336, state 64, 112 SSM heads of 64, vocab 32 000), 12 of 81 layers
     (two super-blocks, so the shared attention block is applied twice and
     its gradient is the sum over both; HYBRID_LAYERS), phase 5's setup at
     seq 256 and a per-client batch of 4 (HYBRID_BATCH). Each round must
     launch K1 and K2 once, K5 2 × (3 + 1) = 8 times and K7 10 × (3 + 1) =
     40 times, and select the plain versions' cohort; one eval forward
     through K5 and K7 is held against the same through their plain versions.
 11. One client visit (fed.client.local_train, 2 steps) of hubert-xlarge at
     every width and all 48 layers on batches of train_4k's shape cut to 2
     sequences of 4096 frames: K5 non-causal at D 80, 48 launches per
     forward. Then the loss and every gradient through K5 against the same
     through its plain version on the card (allowance: 4 bf16 ulp of each
     leaf's largest entry, or twice the gap K5's plain version in f64 opens).
 12. The same visit of llama-3.2-vision-90b at every width, half its
     vocabulary rows (VLM_VOCAB), one super-block (4 self layers and the
     gated cross layer, VLM_LAYERS), batch 1 × seq 4096 with 1601 vision
     tokens: K5 causal in
     the self layers and non-causal over the vision keys (S ≠ T) in the
     cross layer, whose two tanh gates are set to 0.5 (VLM_GATE) so that the
     cross-attention counts. Phases 10–12 print wall time, peak memory and a
     profile (idle share, top ops) as phases 5–7 do.
 13. Slice 8, in a child process of this script that alone sets cuBLAS's
     workspace for deterministic algorithms: phase 3's federation under
     async rounds (K1 + K2 fed the virtual clock's staleness row, an
     availability trace, stragglers, the engine's default draws), killed
     after round 1 and resumed bitwise from its checkpoint (the default
     noise generator's state among it), and phase 4's hierarchical
     federation under async rounds with K4 and with the 'adaptive' edge
     budgets (phase_async).
 14. A JSON line of per-kernel numbers, then the result line.

It needs one card, imports nothing of JAX or of the reference package, and
exits nonzero without printing a result when torch sees no CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
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
               ("D=112 T=1000", 1, 1000, 1000, 64, 8, 112, True, 0),
               ("zamba path", 16, 256, 256, 32, 32, 112, True, 0),
               ("vlm cross", 1, 4096, 1601, 64, 8, 128, False, 0),
               ("vlm cross S=32", 1, 32, 1601, 64, 8, 128, False, 0),
               ("hubert", 2, 4096, 4096, 16, 16, 80, False, 0))
# "zamba path": phase 10's shape (4 clients × batch 4 of 256 tokens, 32 MHA
# heads of 112); "vlm cross": phase 12's cross-attention, 4096 queries over
# 1601 vision keys (25 full 64-key tiles and one of a single key), H 64 /
# KVH 8 of 128, and the same with S = 32 < T; "hubert": phase 11's shape
# (batch 2 × 4096 frames, 16 MHA heads of 80, zero-padded to 128 in shared
# memory), non-causal.
FLASH_TIMED = ("path", "prefill 4096", "kimi path", "zamba path", "vlm cross", "hubert")
# Timed in bf16 only (the models run K5 in bf16; f32 stays checked above).
FLASH_TIMED_BF16 = ("zamba path", "vlm cross", "hubert")
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
             ("HP 128 N 256", 2, 512, 256, 4, 128, 256),
             ("zamba path", 16, 256, 256, 112, 64, 64))
# "zamba path": phase 10's shape, a cohort of 4 clients × batch 4, one
# 256-row chunk, zamba2-7b's 112 heads of 64 and state 64.
SSD_TIMED = ("path", "prefill 4096", "zamba path")
SSD_FORWARD_RTOL = 1e-4
# Phase 6's sequence length: one full chunk of mamba2-370m's ssm_chunk. The
# example's 32 tokens would make K7 compute a 256-row chunk that is 7/8
# padding. While the client visit took its gradient with torch.func.grad
# (which records every op's backward), a 48-layer cohort step needed 77 GB
# at 256 and the phase ran at 128; the visit's vjp keeps no such graph.
SSM_SEQ = 256
# Phase 6's depth: half of mamba2-370m's 48 layers. At 48 the phase took
# ~95 s, ~70 s of it torch.profiler's processing of a cohort call's 43 000
# kernel launches; the cut keeps the script near its earlier length with
# phases 10-12 added.
SSM_LAYERS = 24
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
# Phase 10's cut of zamba2-7b: every published width, 12 of the 81 layers
# (two super-blocks of 5 Mamba2 layers and the shared attention block, so the
# shared block is applied twice and no layer trails; 1 292 666 352 params,
# 2.59 GB), a per-client batch of 4 (8 did not fit: ~20 bytes per bf16
# parameter byte for a cohort step, and ~3.5 GB of activations per Mamba2
# layer at batch 8 × seq 256), seq 256 (one full chunk of its ssm_chunk).
HYBRID_LAYERS = 12
HYBRID_BATCH = 4
# Phases 11 and 12: one client visit (fed.client.local_train) of VISIT_STEPS
# local steps on batches of train_4k's shape (seq 4096) cut to
# ENCODER_BATCH / VLM_BATCH sequences, inputs drawn with numpy from a seed.
# hubert-xlarge runs all 48 layers; llama-3.2-vision-90b one super-block (4
# self layers and the cross layer, the fewest layer_plan takes) at every
# width, with both tanh gates of the cross layer at VLM_GATE (at their zero
# init the cross layer adds exactly nothing) and half its vocabulary rows
# (VLM_VOCAB, the ids drawn from them): at all 128 256 rows the visit's
# second step needed 63.2 GB allocated plus 3.5 GB more, with 13.0 GB of the
# allocator's blocks reserved but free, past the card's 79.2 GB once phases
# 1-11 had run (71.6 GB allocated at its peak in a run without phases 3-9).
VISIT_STEPS = 2
VISIT_LR = 0.05
ENCODER_BATCH = 2
ENCODER_MASK = 0.4
VLM_LAYERS = 5
VLM_VOCAB = 64128
VLM_BATCH = 1
VLM_GATE = 0.5
# Peak memory of phases 5 and 7 before the client visit dropped the recorded
# backward and the all-at-once f32 deltas (this script's run on an H100
# 80GB HBM3 at 700 W, before that change): printed beside this run's. (Phase
# 6 then ran all 48 layers at seq 128: 47 652 597 760 bytes.)
PEAK_BEFORE = {5: (20_444_054_016, 32), 7: (48_821_506_048, 32)}


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


def check_candidates_bitwise(where: str, out_k, out_p) -> None:
    """K2's candidates (cval, cidx) must be its plain version's bit for bit."""
    import torch

    if not (torch.equal(out_k[3].view(torch.int32), out_p[3].view(torch.int32))
            and torch.equal(out_k[4], out_p[4])):
        raise AssertionError(f"{where}: K2's candidates differ from the plain version's")


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
                    check_candidates_bitwise(where, out_k, out_p)
                    # The whole fused selection through kernels vs plain: the
                    # same cohort in the same order.
                    fkw = dict(round_idx=t, tau=tau, m=m, gumbel=gumbel, cfg=cfg,
                               staleness_override=stale)
                    sel_k, probs_k, scores_k = tss.fused_score_select(*rows, **fkw)
                    sel_p, probs_p, scores_p = tss.fused_score_select_plain(*rows, **fkw)
                    if not torch.equal(sel_k, sel_p):
                        raise AssertionError(f"{where}: selected cohorts differ")
                    check_close(f"{where} probs", probs_k, probs_p, atol=1e-30)
                    check_close(f"{where} fused scores", scores_k, scores_p, atol=1e-6)
                    ncases += 1
    torch.cuda.synchronize()
    print(f"phase 2: {ncases} cases, kernels == plain (K2's candidates bitwise, cohorts "
          f"equal in order, rtol {RTOL}); max abs err K1 {err['score_stats']:.3e}, "
          f"K2 {err['score_select']:.3e}", flush=True)
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
        dtypes = (torch.bfloat16,) if name in FLASH_TIMED_BF16 else (torch.bfloat16,
                                                                     torch.float32)
        for dtype in dtypes:
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


def flash_attention_plain_f64(q, k, v, *, causal: bool, window: int = 0):
    """K5's plain version computed in f64, o rounded to q's dtype and the
    log-sum-exp to f32: the same function with other rounding."""
    from repro_torch.kernels import flash_attention as tfa

    o, lse = tfa.flash_attention_plain(q.double(), k.double(), v.double(), causal=causal,
                                       window=window)
    return o.to(q.dtype), lse.float()


def flash_attention_plain_reordered(q, k, v, *, causal: bool, window: int = 0):
    """K5's plain version over 64-key tiles (the bf16 kernel's) instead of
    BLOCK_K = 32: the same function, its f32 sums taken in another order."""
    from repro_torch.kernels import flash_attention as tfa

    saved, tfa.BLOCK_K = tfa.BLOCK_K, 64
    try:
        return tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    finally:
        tfa.BLOCK_K = saved


def phase_lm(dev, phase: int, cfg, seq_len: int, per_round: dict, kernels: tuple,
             plain_f64: dict | None = None, local_batch: int = 8):
    """Phases 5–7 and 10: the federated LM path on the full-width ``cfg``
    through K1, K2 and the model's own kernels (K5 for qwen2, K7 for mamba2,
    K5 and K6 for the kimi-k2 share, K5 and K7 for zamba2), ``per_round``
    launches of each per round; returns the path's launch counts and the eval
    logits' largest gap between the ``kernels`` and their plain versions.
    With ``plain_f64`` (each kernel's plain version with other rounding) the
    allowed gap is at least twice the gap that opens between those and the
    plain versions."""
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
                    local_batch=local_batch, lr=0.05, mu=0.1, seed=0)
    m = fed.num_selected
    data = make_lm_data(fed, vocab=cfg.vocab_size, seq_len=seq_len)
    model = build_model(cfg)
    n_params = sum(math.prod(p.shape) for p in model.module.parameters())
    want_round = {n: 0 for n in launch_counts()}
    want_round.update(score_stats=1, score_select=1, **per_round)
    print(f"phase {phase}: {arch}, {cfg.num_layers} layers, {n_params} params, batch "
          f"{local_batch} x seq {seq_len}, predicted launches per round "
          f"{json.dumps(per_round)}", flush=True)

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

    # One eval forward through the kernels against the same forward through
    # their plain versions, on the trained params; the loss to 1e-3 relative.
    # The bf16 layers carry a 1-ulp rounding difference of one activation
    # onward. K5 (24 layers): logits within 4 bf16 ulp of the largest (on the
    # CPU, reordering K5's plain sums moved qwen2 logits by 1.3 ulp). K7 (48
    # layers), K6 and zamba2's K5 and K7: within 4 ulp or twice the floor,
    # the gap that the plain versions computed in f64 (a rounding-level
    # change of the same function) open against the plain versions.
    batch = {k: v.to(dev) for k, v in data.eval_batch().items()}

    def eval_logits(plain=None):
        """Logits and loss through the kernels, or with ``plain_version(name,
        fn)`` for each name and fn of ``plain`` (fn None: the plain version)."""
        with torch.no_grad(), contextlib.ExitStack() as stack:
            for name, fn in (plain or {}).items():
                stack.enter_context(plain_version(name, fn))
            logits = model.forward(res.params, batch)[..., :cfg.vocab_size].float()
            return logits, float(model.loss(res.params, batch))

    t0 = time.perf_counter()
    logits_k, loss_k = eval_logits()
    logits_p, loss_p = eval_logits(dict.fromkeys(kernels))
    gap = float((logits_k - logits_p).abs().max())
    top = float(bf16_ulp(logits_p.abs().max()))
    allowed, floor = 4 * top, None
    if plain_f64 is not None:
        floor = float((eval_logits(plain_f64)[0] - logits_p).abs().max())
        allowed = max(allowed, 2 * floor)
    names = " and ".join(kernels)
    if not gap <= allowed or abs(loss_k - loss_p) > 1e-3 * abs(loss_p):
        raise AssertionError(f"eval logits through {names} vs plain: max gap {gap:.3e} "
                             f"(bf16 ulp of the top logit {top:.3e}, floor {floor}), "
                             f"loss {loss_k} vs {loss_p}")
    print(f"phase {phase}: K=8 m={m}, {fed.rounds} rounds x {LM_STEPS} steps x batch "
          f"{fed.local_batch} x seq {seq_len}, wall {wall:.2f} s", flush=True)
    for t in range(fed.rounds):
        print(f"  round {t}: select_ms {res.select_ms[t]:.3f}  execute_ms "
              f"{res.execute_ms[t]:.3f}  aggregate_ms {res.aggregate_ms[t]:.3f}  "
              f"eval_ms {res.eval_ms[t]:.3f}  exp(-loss) {res.accuracy[t]:.6e}", flush=True)
    print(f"  eval logits {names} vs plain ({time.perf_counter() - t0:.2f} s): max abs "
          f"gap {gap:.4e} ({gap / top:.2f} bf16 "
          f"ulp of the top logit), loss {loss_k:.6f} vs {loss_p:.6f}"
          + (f"; floor (plain f64 vs plain f32) {floor:.4e} ({floor / top:.2f} ulp)"
             if floor is not None else ""), flush=True)
    print(f"  labeled_summary {json.dumps(res.labeled_summary())}", flush=True)
    print(f"  train_loss {res.train_loss.tolist()}", flush=True)
    print(f"  params {n_params}  max_memory_allocated {peak} bytes"
          + (f"  ({cfg.expert_deployment})" if cfg.family == "moe" else ""), flush=True)
    if phase in PEAK_BEFORE:
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
        t0 = time.perf_counter()
        prof = profile_phase(fn)
        if what == "execute":
            prof["kernel_launches_per_local_step"] = prof["kernel_launches"] / LM_STEPS
        print(f"  profile {what} ({time.perf_counter() - t0:.2f} s): " + json.dumps(prof),
              flush=True)
    return launches, gap


def visit_batches(cfg, batch: int, steps: int, dev, seed: int = 0) -> dict:
    """``steps`` batches of train_4k's shape cut to ``batch`` sequences, with
    ``data.input_specs``' names and dtypes, drawn with numpy from ``seed``:
    frames and vision embeddings N(0, 1), the encoder's mask over
    ENCODER_MASK of the positions, labels (and tokens) uniform over the
    vocabulary; an LM's labels are its tokens (the loss shifts them)."""
    import torch
    from repro_torch.configs import get_shape
    from repro_torch.data import input_specs

    rng = np.random.default_rng(seed)
    specs = input_specs(cfg, dataclasses.replace(get_shape("train_4k"), global_batch=batch))
    out = {}
    for name, spec in specs.items():
        dims = (steps, *spec.shape)
        if spec.dtype == torch.bool:
            a = torch.from_numpy(rng.uniform(size=dims) < ENCODER_MASK)
        elif spec.dtype == torch.int32:
            a = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=dims, dtype=np.int32))
        else:
            a = torch.from_numpy(rng.standard_normal(size=dims, dtype=np.float32)).to(spec.dtype)
        out[name] = a.to(dev)
    if "tokens" in out:
        out["labels"] = out["tokens"]
    return out


def phase_visit(dev, phase: int, cfg, batch: int, gates: float | None = None):
    """Phases 11 and 12: one client visit (``fed.client.local_train``,
    VISIT_STEPS steps of FedProx SGD) of the full-width ``cfg`` on batches of
    train_4k's shape cut to ``batch``, through K5 (one launch per attention
    layer per forward; the backward is plain PyTorch). ``gates`` sets both
    tanh gates of every vlm cross layer. Then the loss and every leaf's
    gradient on the first batch through K5 against the same through its
    plain version on the card: the loss to 1e-3 relative, each leaf within 4
    bf16 ulp of its largest entry or twice the floor, as phase_lm holds eval
    logits. The floor is the larger gap that a rounding-level change of K5's
    plain version opens against it: computed in f64, or summed over 64-key
    tiles (the bf16 kernel's) in f32. Rounded to bf16, the f64 version's
    output nearly always equals the f32 one's, so a leaf that sums many
    bf16 products (a vlm gate's gradient) moves with the summation order,
    as it does through the kernel, and not with f64. The floor is computed
    only where a gap passes 4 ulp. Returns the launch counts and the largest
    gap as a share of its allowance."""
    import torch
    from repro_torch.fed.client import fedprox_grad, local_train
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg)
    n_params = sum(math.prod(p.shape) for p in model.module.parameters())
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    if gates is not None:
        for name in ("cross_layers.gate_attn", "cross_layers.gate_mlp"):
            params[name].fill_(gates)
    batches = visit_batches(cfg, batch, VISIT_STEPS, dev)
    torch.cuda.synchronize()
    set_up = time.perf_counter() - t0
    seq = batches["labels"].shape[-1]
    want = {n: 0 for n in launch_counts()}
    want["flash_attention"] = cfg.num_layers * VISIT_STEPS
    print(f"phase {phase}: {cfg.name}, {cfg.num_layers} layers, {n_params} params, one "
          f"client visit of {VISIT_STEPS} steps x batch {batch} x seq {seq}"
          + (f", cross-attention over {cfg.vision_tokens} vision tokens, gates {gates}"
             if gates is not None else "")
          + f"; predicted K5 launches {cfg.num_layers} x {VISIT_STEPS} = "
          f"{want['flash_attention']}", flush=True)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = local_train(model.loss, params, batches, lr=VISIT_LR, mu=0.1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != want:
        raise AssertionError(f"{cfg.name} visit launches {launches}, want {want}")
    mean_loss, sq = float(res.mean_loss), float(res.update_sqnorm)
    if not (math.isfinite(mean_loss) and math.isfinite(sq) and sq > 0):
        raise AssertionError(f"visit loss {mean_loss}, update sqnorm {sq}")
    for name, p in res.params.items():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"non-finite parameter {name}")
    del res
    print(f"  set-up {set_up:.2f} s; visit wall {wall:.2f} s, mean loss {mean_loss:.6f}, "
          f"||dw||^2 {sq:.6e}, "
          f"max_memory_allocated {peak} bytes; launches {json.dumps(launches)}", flush=True)

    first = {k: v[0] for k, v in batches.items()}

    def loss_and_grads(*plain):
        """Through K5, or with ``plain_version("flash_attention", *plain)``
        when ``plain`` is given (``None``: the plain version)."""
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_version("flash_attention", *plain))
            loss, grads = fedprox_grad(model.loss, params, params, first, 0.0)
            return float(loss), grads

    t0 = time.perf_counter()
    loss_p, grads_p = loss_and_grads(None)
    loss_k, grads = loss_and_grads()
    gaps = {n: float((g.float() - grads_p[n].float()).abs().max()) for n, g in grads.items()}
    del grads
    ulps = {n: 4 * float(bf16_ulp(g.float().abs().max())) for n, g in grads_p.items()}
    # The floor can only widen an allowance: its two passes (the f64 one the
    # slowest) run only where a leaf's gap passes 4 bf16 ulp.
    floors, floor_losses = {}, []
    if any(gaps[n] > ulps[n] for n in gaps):
        for plain in (flash_attention_plain_f64, flash_attention_plain_reordered):
            loss_f, grads = loss_and_grads(plain)
            floor_losses.append(loss_f)
            for n, g in grads.items():
                floors[n] = max(floors.get(n, 0.0),
                                float((g.float() - grads_p[n].float()).abs().max()))
            del grads
    del grads_p
    worst, worst_name = 0.0, None
    for name, gap in gaps.items():
        allowed = max(ulps[name], 2 * floors.get(name, 0.0))
        if allowed == 0.0:
            if gap != 0.0:
                raise AssertionError(f"{name}: gradient gap {gap} where the plain "
                                     "versions agree exactly")
            continue
        if gap / allowed > worst:
            worst, worst_name = gap / allowed, name
    if worst > 1.0 or abs(loss_k - loss_p) > 1e-3 * abs(loss_p):
        raise AssertionError(f"{cfg.name} gradients through K5 vs plain: worst leaf "
                             f"{worst_name} at {worst:.3f} of its allowance; loss {loss_k} "
                             f"vs {loss_p}")
    print(f"  loss and gradients through K5 vs plain ({time.perf_counter() - t0:.2f} s): "
          f"loss {loss_k:.6f} vs {loss_p:.6f}; worst leaf {worst_name} at {worst:.3f} of "
          f"its allowance (gap {gaps.get(worst_name)}, 4 bf16 ulp of its largest "
          f"{ulps.get(worst_name)}, floor "
          + (f"{floors.get(worst_name)}; losses of the f64 and 64-key-tile plain versions "
             f"{floor_losses})" if floors else "not needed)"), flush=True)

    # Where the time goes: one more local step's gradient under torch.profiler.
    t0 = time.perf_counter()
    prof = profile_phase(lambda: fedprox_grad(model.loss, params, params, first, 0.1))
    print(f"  profile step ({time.perf_counter() - t0:.2f} s): " + json.dumps(prof),
          flush=True)
    print(f"  peak memory {peak} bytes (the visit)", flush=True)
    return launches, worst


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
                      check_close(f"{where} K2 (m_b, l_b)", out_k[2], out_p[2]))
            check_candidates_bitwise(where, out_k, out_p)
        kw = dict(round_idx=t, tau=tau, m=m, gumbel=gumbel, cfg=cfg)
        sel_s, probs_s, scores_s = tss.sharded_score_select_in_process(*rows, world=world,
                                                                       **kw)
        sel_f, probs_f, scores_f = tss.fused_score_select(*rows, **kw)
        if not torch.equal(sel_s, sel_f):
            raise AssertionError(f"K8 W={world} in one process, {dtype}: the merged cohort "
                                 "is not the single-device cohort")
        check_close(f"K8 W={world} {dtype} probs", probs_s, probs_f, atol=1e-30)
        check_close(f"K8 W={world} {dtype} scores", scores_s, scores_f, atol=1e-6)
    torch.cuda.synchronize()
    print(f"phase 2: K8 offsets, K={k} in {world} shards, f32 and bf16: K1 and K2 with "
          f"each shard's offset == plain (rtol {RTOL}, candidates bitwise), max abs err "
          f"{err:.3e}; the in-process merge selects the single-device cohort in order",
          flush=True)
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


# Every collective of torch.distributed that a K8 call could make.
COLLECTIVES = ("all_gather", "all_gather_coalesced", "all_gather_into_tensor",
               "all_gather_object", "all_gather_single", "all_reduce", "all_reduce_coalesced",
               "all_to_all", "all_to_all_single", "barrier", "batch_isend_irecv", "broadcast",
               "broadcast_object_list", "gather", "gather_object", "irecv", "isend", "recv",
               "recv_object_list", "reduce", "reduce_scatter", "reduce_scatter_single",
               "reduce_scatter_tensor", "scatter", "scatter_object_list", "send",
               "send_object_list")


def count_collectives(fn) -> dict:
    """Calls of each torch.distributed collective made by one call of ``fn``."""
    import torch.distributed as dist

    counts, saved = {}, {}
    for name in COLLECTIVES:
        if hasattr(dist, name):
            saved[name] = getattr(dist, name)

            def counted(*args, _fn=saved[name], _name=name, **kwargs):
                counts[_name] = counts.get(_name, 0) + 1
                return _fn(*args, **kwargs)

            setattr(dist, name, counted)
    try:
        fn()
    finally:
        for name, f in saved.items():
            setattr(dist, name, f)
    return counts


# Phase 8's breakdown: the functions of kernels/score_select.py under each
# label (none nests in another), and K8's all-gathers as "collectives".
# K1 and K2 launch through ctypes, outside any PyTorch operator, so the
# profiler ties their kernels to no range: their device time is read by
# kernel name.
BREAKDOWN = (("pack", ("_pack",)), ("K1", ("score_stats",)), ("K2", ("score_select",)),
             ("stats", ("_combine_stats", "_shard_stats", "_global_stats")),
             ("normalize", ("_normalize", "_shard_normalizer", "_global_normalizer",
                            "_shard_probs")),
             ("merge", ("top_candidates", "candidate_keys", "merge_keys")))
BY_KERNEL = {"K1": "stats_kernel", "K2": "select_kernel"}


def profile_breakdown(fn, iters: int = 10) -> dict:
    """Per call of ``fn`` under torch.profiler: host wall ms, the CUDA
    kernels' device ms, and for each BREAKDOWN label (and K8's all-gathers)
    its calls, host ms and device ms (of the kernels launched inside it).
    The rest of the wall time is the wrappers' own Python and the slices."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import score_select as tss

    def labelled(label, f):
        def run(*args, **kwargs):
            with record_function(label):
                return f(*args, **kwargs)
        return run

    saved = [(tss, name, label) for label, names in BREAKDOWN for name in names]
    saved = [(obj, name, label, getattr(obj, name)) for obj, name, label in saved]
    saved.append((tss._GroupComm, "gather", "collectives", tss._GroupComm.gather))
    labels = [lb for lb, _ in BREAKDOWN] + ["collectives"]
    try:
        for obj, name, label, f in saved:
            setattr(obj, name, labelled(label, f))
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, name, _, f in saved:
            setattr(obj, name, f)
    # The ranges also show on the device's timeline (as spans, not kernels).
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in labels]
    out = {"wall_ms": wall / iters,
           "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / iters}
    events = prof.events()
    for label in labels:
        evs = [e for e in events if e.name == label and e.device_type == DeviceType.CPU]
        dev_us = (sum(e.self_device_time_total for e in kernels if BY_KERNEL[label] in e.key)
                  if label in BY_KERNEL else sum(e.device_time_total for e in evs))
        out[label] = {"calls": len(evs) / iters,
                      "host_ms": sum(e.cpu_time_total for e in evs) / 1e3 / iters,
                      "device_ms": dev_us / 1e3 / iters}
    return out


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
            if not torch.equal(sel_p, sel_s):
                raise AssertionError(f"K={k}: K8's cohort is not its plain version's")
            err = max(check_close(f"K={k} K8 probs vs plain", probs_s, probs_p, atol=1e-30),
                      check_close(f"K={k} K8 scores vs plain", scores_s, scores_p, atol=1e-6))
            row = {"K": k, "m": m, "cohorts_equal": set_u == set_f,
                   "boundary_gap": gap, "f32_rounding": rounding, "sharded_vs_plain_err": err}
            iters = 100 if k <= 10_000 else 20
            for name, fn in methods.items():
                row[f"{name}_ms"] = time_ms(fn, iters)
                row[f"{name}_device_ms"] = device_ms(fn, None, iters=10)
            counts = count_collectives(methods["sharded"])
            row["sharded_collectives_per_call"] = sum(counts.values())
            if row["sharded_collectives_per_call"] > 4:
                raise AssertionError(f"K={k}: K8 made {counts} collective calls, over 4")
            if k == TABLE8_KS[-1]:
                row["sharded_plain_ms"] = time_ms(plain, iters)
                row["sharded_plain_device_ms"] = device_ms(plain, None, iters=10)
                row["sharded_bound_ms"] = k8_work(k, 2, m) / HBM_BYTES_PER_S * 1e3
                for name in ("fused", "sharded"):
                    print(f"breakdown {json.dumps({'K': k, 'method': name})} "
                          + json.dumps(profile_breakdown(methods[name])), flush=True)
            rows.append(row)
            print("table8 " + json.dumps(row), flush=True)
    finally:
        dist.destroy_process_group()
    print(f"phase 8: Table 8 control plane, K {list(TABLE8_KS)}, bf16 state: fused == "
          f"sharded (one-rank NCCL) bitwise, sharded == its plain version (cohort in order, "
          f"probs and scores rtol {RTOL}), cohorts equal as sets; collectives per K8 call "
          f"{[r['sharded_collectives_per_call'] for r in rows]}; launches "
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


# Phase 13 (slice 8): phase 3's federation under async rounds, with slow
# clients (multipliers ≥ 2.5 miss the 1.5 deadline and carry over) and about
# a quarter of the clients offline each round.
ASYNC_ROUNDS = 4
ASYNC_MULT = (1.0, 3.0, 0.5, 2.5, 1.0, 4.0, 0.8, 1.2, 2.8, 0.6, 1.0, 3.5)
ASYNC_CFG = dict(deadline=1.5, over_select_frac=0.5, jitter=0.1)
HIER_ASYNC_ROUNDS = 3
# Phase 13c's 24 clients: two slow ones, so most edges land by the deadline
# and the adaptive budgets see several edges' losses a round.
HIER_ASYNC_SLOW = {5: 3.0, 17: 3.0}


def same_run(a, b) -> list:
    """The series and parameters on which two runs differ (bitwise)."""
    import torch

    diff = [name for name in ("selected_history", "accuracy", "train_loss", "wall_clock",
                              "round_staleness")
            if np.asarray(getattr(a, name)).tobytes() != np.asarray(getattr(b, name)).tobytes()]
    return diff + [k for k, p in a.params.items()
                   if p.dtype != b.params[k].dtype
                   or not torch.equal(p.view(torch.uint8), b.params[k].view(torch.uint8))]


def phase_async(dev, err: dict):
    """Phase 13: slice 8 on the card.

    13a. Flat async rounds on phase 3's full-width federation under
    heterosel_pallas: each round's dispatch must equal the plain versions'
    selection on the same state, clock override and draws (K1 + K2's plain
    versions with the override, the availability re-sample, minus the
    clients in flight), with K1 and K2 launched once each and the override
    on (``use_ov``); some round must aggregate a straggler of an earlier
    round. The runs take the engine's default draws, from its noise
    generator on the card. 13b. The same run killed after round 1 behind a
    CheckpointHook and resumed in a fresh engine, which restores the
    generator's state, must equal the uninterrupted run bitwise (if two
    uninterrupted runs differ, both are made again under
    ``torch.use_deterministic_algorithms``). 13c. Phase 4's hierarchical
    federation under async rounds: heterosel_pallas (K4 once a round against
    its plain version, cohorts equal to the plain selection's) and
    'adaptive' (no launch; each edge's cohort within its budget; budgets
    that move away from the static split and stay within m). Returns the
    launch counts of 13a's and 13c's checked runs, by path."""
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import FedConfig, get_config
    from repro_torch.core.scoring import HeteRoScoreConfig
    from repro_torch.core.selection import SelectorConfig, dynamic_temperature, gumbel_noise
    from repro_torch.core.state import score_inputs
    from repro_torch.data import make_vision_data
    from repro_torch.fed import (AsyncConfig, AvailabilityTrace, CheckpointHook,
                                 FederatedSpec, HierarchyConfig, KillAtRound, RoundHook,
                                 SimulatedPreemption, availability, edge_budgets)
    from repro_torch.kernels import score_select as tss
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    fed = FedConfig(num_clients=12, participation=0.5, rounds=ASYNC_ROUNDS, local_batch=32,
                    lr=0.01, mu=0.1, dirichlet_alpha=0.1, seed=0, round_policy="async")
    data = make_vision_data(fed)
    model = build_model(get_config("resnet18-cifar10"))
    avail = AvailabilityTrace(fed.num_clients, p_stay_online=0.75, p_come_online=0.75,
                              seed=fed.seed).masks(fed.rounds)
    mult = np.asarray(ASYNC_MULT)
    acfg = AsyncConfig(**ASYNC_CFG)
    m_over = math.ceil(fed.num_selected * (1 + acfg.over_select_frac))

    use_ov = []
    real_select = tss.score_select

    def spy_select(*args, **kwargs):
        use_ov.append(kwargs["use_ov"])
        return real_select(*args, **kwargs)

    class CheckAsync(RoundHook):
        """Per round: the dispatch equals the plain versions' selection on the
        same state, override and draws; K1 and K2 launched once each, K2 with
        the override on."""

        def __init__(self):
            self.rows = []

        def on_run_start(self, ctx):
            # Each round's default draws are taken once: this hook reads
            # them before the engine's selection does.
            eng, memo = ctx.engine, {}
            base = eng.noise

            def noise(t, k):
                if t not in memo:
                    memo[t] = base(t, k)
                return memo[t]

            eng.noise = noise

        def on_round_start(self, ctx):
            t, eng = ctx.round_idx, ctx.engine
            stale = eng.staleness_override()
            draws = eng.round_noise(t)
            _, probs, _ = tss.fused_score_select_plain(
                *score_inputs(eng.state), round_idx=t,
                tau=dynamic_temperature(t, SelectorConfig(num_selected=m_over)), m=m_over,
                gumbel=draws["gumbel"], cfg=HeteRoScoreConfig(), staleness_override=stale)
            mask, _ = availability.remask(draws["remask"], probs, avail[t], m_over)
            self.expected = mask.cpu().numpy() & ~eng._in_flight
            self.stale = stale.cpu().numpy()
            self.before = dict(tss.LAUNCHES)
            use_ov.clear()

        def on_round_end(self, ctx):
            t, eng = ctx.round_idx, ctx.engine
            grew = {n: tss.LAUNCHES[n] - self.before[n] for n in tss.LAUNCHES}
            if grew != {"score_stats": 1, "score_select": 1, "score_probs": 0,
                        "segment_probs": 0} or use_ov != [True]:
                raise AssertionError(f"round {t}: launches {grew}, use_ov {use_ov}")
            if not np.array_equal(ctx.mask, self.expected):
                raise AssertionError(f"round {t}: dispatch {np.flatnonzero(ctx.mask)} != "
                                     f"plain {np.flatnonzero(self.expected)}")
            if ctx.mask[~avail[t]].any():
                raise AssertionError(f"round {t}: an offline client was dispatched")
            finite = self.stale[self.stale < 1e5]
            row = {"round": t, "dispatch": np.flatnonzero(ctx.mask).tolist(),
                   "arrivals": ctx.num_arrivals, "stragglers": ctx.num_stragglers,
                   "wall_clock": eng.wall_clock[-1],
                   "round_staleness": eng.round_staleness[-1],
                   "override_finite": [float(x) for x in finite],
                   "offline": int((~avail[t]).sum())}
            self.rows.append(row)
            print(f"round {t}: dispatch == plain {row['dispatch']}; arrivals "
                  f"{row['arrivals']}, stragglers {row['stragglers']}, wall_clock "
                  f"{row['wall_clock']:.4f}, round_staleness {row['round_staleness']:.4f}, "
                  f"offline {row['offline']}, override {row['override_finite']}", flush=True)

    ckpt_ms = {"save": [], "restore": []}

    class TimedCheckpoint(CheckpointHook):
        """CheckpointHook with its save and restore host times recorded."""

        def on_run_start(self, ctx):
            t0 = time.perf_counter()
            super().on_run_start(ctx)
            if ctx.engine.start_round:
                ckpt_ms["restore"].append((time.perf_counter() - t0) * 1e3)

        def on_round_end(self, ctx):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().on_round_end(ctx)
            ckpt_ms["save"].append((time.perf_counter() - t0) * 1e3)

    def flat_run(hooks):
        return FederatedSpec(model, fed, data, selector="heterosel_pallas", steps_per_round=4,
                             system=mult, async_cfg=acfg, availability=avail, device=dev,
                             hooks=hooks).build()

    def checked_run():
        check = CheckAsync()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        tss.score_select = spy_select
        try:
            t0 = time.perf_counter()
            eng = flat_run([check])
            res = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            tss.score_select = real_select
        return res, eng, check, wall, launch_counts(), torch.cuda.max_memory_allocated(dev)

    # 13a, then a second uninterrupted run (13b's determinism check).
    res_a, eng_a, check, wall, launches, peak = checked_run()
    res_b = flat_run([]).run()
    diff = same_run(res_a, res_b)
    forced = bool(diff)
    if forced:
        print(f"phase 13: two uninterrupted runs differ on {len(diff)} series and "
              f"parameters {diff[:6]}; 13a and 13b again under "
              "torch.use_deterministic_algorithms(True)", flush=True)
        torch.use_deterministic_algorithms(True, warn_only=True)
        res_a, eng_a, check, wall, launches, peak = checked_run()
        res_b = flat_run([]).run()
        diff = same_run(res_a, res_b)
        if diff:
            raise AssertionError(f"deterministic runs still differ on {diff[:6]}")
    if launches != {"score_stats": fed.rounds, "score_select": fed.rounds,
                    "score_probs": 0, "segment_probs": 0, "sharded_score_select": 0,
                    "flash_attention": 0, "grouped_matmul": 0, "ssd_chunk": 0}:
        raise AssertionError(f"async path launches {launches}")
    if eng_a.stragglers_carried == 0 or not np.any(res_a.round_staleness > 0):
        raise AssertionError("no straggler of an earlier round was aggregated")
    if not np.all(np.isfinite(res_a.train_loss)) or not all(
            bool(torch.isfinite(p).all()) for p in res_a.params.values()):
        raise AssertionError("non-finite loss or parameters")
    print(f"phase 13a: async resnet18-cifar10, K={fed.num_clients} m={fed.num_selected} "
          f"m_over={m_over}, {fed.rounds} rounds x 4 steps x batch {fed.local_batch}, "
          f"deadline {acfg.deadline}, jitter {acfg.jitter}, wall {wall:.2f} s, "
          f"stragglers carried {eng_a.stragglers_carried}", flush=True)
    for t in range(fed.rounds):
        print(f"  round {t}: select_ms {res_a.select_ms[t]:.3f}  execute_ms "
              f"{res_a.execute_ms[t]:.3f}  aggregate_ms {res_a.aggregate_ms[t]:.3f}  "
              f"eval_ms {res_a.eval_ms[t]:.3f}", flush=True)
    print(f"  wall_clock {res_a.wall_clock.tolist()}", flush=True)
    print(f"  round_staleness {res_a.round_staleness.tolist()}", flush=True)
    print(f"  train_loss {res_a.train_loss.tolist()}", flush=True)
    print(f"  max_memory_allocated {peak} bytes", flush=True)
    print(f"  launches {json.dumps(launches)}", flush=True)
    print(f"phase 13b: determinism {'forced' if forced else 'not forced'}: two "
          "uninterrupted runs equal bitwise", flush=True)

    # 13b: kill after round 1, resume in a fresh engine.
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        try:
            flat_run([TimedCheckpoint(ckdir, keep_last=1), KillAtRound(1)]).run()
            raise AssertionError("KillAtRound(1) did not stop the run")
        except SimulatedPreemption as stop:   # the kill this phase asks for
            print(f"phase 13b: {stop}", flush=True)
        snap_bytes = sum(os.path.getsize(os.path.join(ckdir, f)) for f in os.listdir(ckdir))
        eng_c = flat_run([TimedCheckpoint(ckdir, keep_last=1)])
        res_c = eng_c.run()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    if eng_c.start_round != 2:
        raise AssertionError(f"resumed from round {eng_c.start_round}, want 2")
    gens = {name: g.device.type for name, g in eng_c.generators.items()}
    if gens != {"noise": "cuda"}:
        raise AssertionError(f"the resumed run's default draws come from {gens}")
    diff = same_run(res_a, res_c)
    if diff:
        raise AssertionError(f"the resumed run differs from the uninterrupted one on {diff[:6]}")
    print(f"phase 13b: killed after round 1 and resumed from round 2 (the card's noise "
          f"generator state restored): selection history, "
          f"metric, train_loss, wall_clock, round_staleness and all {len(res_c.params)} "
          f"parameters bitwise equal; snapshot {snap_bytes} bytes; save_ms "
          f"{[round(x, 3) for x in ckpt_ms['save']]}; restore_ms "
          f"{[round(x, 3) for x in ckpt_ms['restore']]}", flush=True)
    release(dev)

    # 13c: phase 4's federation under async rounds.
    hfed = FedConfig(num_clients=24, participation=0.5, rounds=HIER_ASYNC_ROUNDS,
                     local_batch=32, lr=0.01, mu=0.1, dirichlet_alpha=0.1, seed=0,
                     topology="hierarchical", edge_count=4, round_policy="async")
    hdata = make_vision_data(hfed)
    hmult = np.ones(hfed.num_clients)
    hmult[list(HIER_ASYNC_SLOW)] = list(HIER_ASYNC_SLOW.values())
    drawn = {}
    noise_gen = torch.Generator(device=dev).manual_seed(hfed.seed)

    def edge_noise(t, stream, n):
        if (t, stream) not in drawn:
            drawn[t, stream] = gumbel_noise(noise_gen, n)
        return drawn[t, stream]

    class CheckHier(RoundHook):
        """Per round under heterosel_pallas: the dispatch equals the plain
        selection's on the same state and draws (through K4's plain version,
        whose probabilities K4's are held against). Under 'adaptive', which
        has no kernel: no launch, and each edge's cohort within the budget
        it was dispatched under."""

        def __init__(self, selector):
            self.pallas = selector == "heterosel_pallas"
            self.selector = selector
            self.max_abs_err = 0.0
            self.budgets = []

        def on_round_start(self, ctx):
            t, eng = ctx.round_idx, ctx.engine
            if self.pallas:
                picks = eng.select_round(t, scorer=tss.segmented_score_probs_plain)
                self.plain_out = eng.segment_out
                self.expected = np.zeros(hfed.num_clients, bool)
                for _, members in picks:
                    self.expected[members] = True
            self.start_budgets = np.asarray(eng.budgets).copy()
            self.before = dict(tss.LAUNCHES)

        def on_round_end(self, ctx):
            t, eng = ctx.round_idx, ctx.engine
            grew = {n: tss.LAUNCHES[n] - self.before[n] for n in tss.LAUNCHES}
            if grew != {"score_stats": 0, "score_select": 0, "score_probs": 0,
                        "segment_probs": int(self.pallas)}:
                raise AssertionError(f"round {t}: launches {grew}")
            if self.pallas:
                (pk, sk), (pp, sp) = eng.segment_out, self.plain_out
                self.max_abs_err = max(self.max_abs_err,
                                       check_close(f"round {t} K4 scores", sk, sp, atol=1e-6),
                                       check_close(f"round {t} K4 probs", pk, pp, atol=1e-30))
                if not np.array_equal(ctx.mask, self.expected):
                    raise AssertionError(f"round {t}: dispatch {np.flatnonzero(ctx.mask)} != "
                                         f"plain {np.flatnonzero(self.expected)}")
            else:
                per_edge = np.bincount(eng.partition.assignment[ctx.mask],
                                       minlength=eng.edge_count)
                if (per_edge > self.start_budgets).any():
                    raise AssertionError(f"round {t}: cohorts {per_edge.tolist()} over the "
                                         f"budgets {self.start_budgets.tolist()}")
            self.budgets.append(np.asarray(eng.budgets).tolist())
            what = "dispatch == plain" if self.pallas else "dispatch within budgets"
            print(f"round {t} ({self.selector}): {what} "
                  f"{np.flatnonzero(ctx.mask).tolist()}; budgets {self.budgets[-1]}; cloud "
                  f"arrivals {ctx.num_arrivals}, stragglers {ctx.num_stragglers}, "
                  f"wall_clock {eng.wall_clock[-1]:.4f}", flush=True)

    hier_launches = {}
    for selector in ("heterosel_pallas", "adaptive"):
        check = CheckHier(selector)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        eng = FederatedSpec(model, hfed, hdata, selector=selector, steps_per_round=4,
                            system=hmult, async_cfg=AsyncConfig(deadline=1.5, jitter=0.1),
                            hier_cfg=HierarchyConfig(edges_per_round=3 if selector ==
                                                     "heterosel_pallas" else 0),
                            device=dev, edge_noise=edge_noise, hooks=[check]).build()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        if selector == "heterosel_pallas":
            hier_launches = counts
            if counts["segment_probs"] != hfed.rounds or sum(counts.values()) != hfed.rounds:
                raise AssertionError(f"hierarchical async launches {counts}")
            err["segment_probs"] = max(err["segment_probs"], check.max_abs_err)
        else:
            static = edge_budgets(hfed.num_selected, eng.partition.sizes).tolist()
            if sum(counts.values()) or all(b == static for b in check.budgets) \
                    or any(sum(b) > hfed.num_selected for b in check.budgets):
                raise AssertionError(f"adaptive: launches {counts}, budgets {check.budgets} "
                                     f"(static {static})")
        if not np.all(np.isfinite(res.train_loss)):
            raise AssertionError(f"non-finite train loss {res.train_loss}")
        print(f"phase 13c: hierarchical async {selector}, K={hfed.num_clients} "
              f"E={hfed.edge_count}, {hfed.rounds} rounds, wall {wall:.2f} s, cloud_uploads "
              f"{res.cloud_uploads.tolist()}, wall_clock {res.wall_clock.tolist()}, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} bytes, "
              f"launches {json.dumps(counts)}", flush=True)
        for t in range(hfed.rounds):
            print(f"  round {t}: select_ms {res.select_ms[t]:.3f}  execute_ms "
                  f"{res.execute_ms[t]:.3f}  aggregate_ms {res.aggregate_ms[t]:.3f}",
                  flush=True)
    if forced:
        torch.use_deterministic_algorithms(False)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, hier_launches


def run_phase_async(err: dict):
    """Phase 13 in a child process of this script, with the cuBLAS workspace
    setting that deterministic algorithms require (cuBLAS reads it when a
    handle is made), so phases 1-12 run with the default. The child reuses
    the kernels built on disk. Returns its launch counts by path and folds
    its K4 error into ``err``."""
    import tempfile

    fd, out = tempfile.mkstemp(prefix="chip_smoke_phase13_", suffix=".json")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase-13",
                               out], env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
        if proc.returncode != 0:
            raise RuntimeError(f"phase 13's process exited with {proc.returncode}")
        with open(out) as f:
            got = json.load(f)
    finally:
        os.unlink(out)
    print(f"phase 13: its process took {time.perf_counter() - t0:.1f} s", flush=True)
    err["segment_probs"] = max(err["segment_probs"], got["segment_probs_err"])
    return got["async"], got["async_hierarchical"]


def phase_async_child(out: str) -> int:
    """The child of ``run_phase_async``: phase 13, its result into ``out``."""
    from repro_torch.device import resolve_device

    err = {"segment_probs": 0.0}
    flat, hier = phase_async(resolve_device("cuda"), err)
    with open(out, "w") as f:
        json.dump({"async": flat, "async_hierarchical": hier,
                   "segment_probs_err": err["segment_probs"]}, f)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--phase-13"]:
        return phase_async_child(sys.argv[2])
    from repro_torch.configs import expert_share, get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.models import hybrid

    dev = resolve_device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)

    start = t0 = time.perf_counter()

    def lap(phase: int) -> None:
        print(f"chip_smoke: phase {phase} done at {time.perf_counter() - start:.1f} s",
              flush=True)

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

    lap(1)
    err, timings = phase_kernels(dev)
    k8_err = phase_k8_offsets(dev)
    flash_err, flash_timings = phase_flash(dev)
    gmm_err, gmm_timings = phase_gmm(dev)
    ssd_err, ssd_fwd_err, ssd_timings = phase_ssd(dev)
    lap(2)
    paths = {"flat": phase_main_path(dev)}
    lap(3)
    paths["hierarchical"] = phase_hierarchy(dev, err)
    lap(4)
    # Per layer per round: one launch per local step and one in the eval
    # (the vmap rules fold the cohort into one launch; K5's and K7's
    # backwards are plain PyTorch). K6: three grouped products per forward
    # and three dX products per backward (dW is plain PyTorch).
    per_layer = {"flash_attention": LM_STEPS + 1, "ssd_chunk": LM_STEPS + 1,
                 "grouped_matmul": LM_STEPS * (3 + 3) + 3}

    def per_round(cfg, *names):
        return {n: cfg.num_layers * per_layer[n] for n in names}

    cfg = get_config("qwen2-0.5b")
    paths["lm"], lm_gap = phase_lm(dev, 5, cfg, 32, per_round(cfg, "flash_attention"),
                                   ("flash_attention",))
    release(dev)
    lap(5)
    cfg = dataclasses.replace(get_config("mamba2-370m"), num_layers=SSM_LAYERS)
    paths["ssm"], ssm_gap = phase_lm(dev, 6, cfg, SSM_SEQ, per_round(cfg, "ssd_chunk"),
                                     ("ssd_chunk",),
                                     plain_f64={"ssd_chunk": ssd_chunk_plain_f64})
    release(dev)
    lap(6)
    cfg = expert_share(get_config("kimi-k2-1t-a32b"), **MOE_SHARE)
    paths["moe"], moe_gap = phase_lm(
        dev, 7, cfg, 32, per_round(cfg, "flash_attention", "grouped_matmul"),
        ("grouped_matmul",), plain_f64={"grouped_matmul": gmm_plain_f64})
    release(dev)
    lap(7)
    paths["table8"], table8 = phase_table8(dev)
    lap(8)
    paths["table1"], _ = phase_table1(dev)
    release(dev)
    lap(9)
    # Phase 10: the shared block through K5 once per super-block, the Mamba2
    # layers through K7, each once per local step and once in the eval.
    cfg = dataclasses.replace(get_config("zamba2-7b"), num_layers=HYBRID_LAYERS)
    n_super, per, tail = hybrid.layer_plan(cfg)
    paths["hybrid"], hybrid_gap = phase_lm(
        dev, 10, cfg, SSM_SEQ, {"flash_attention": n_super * per_layer["flash_attention"],
                                "ssd_chunk": (n_super * per + tail) * per_layer["ssd_chunk"]},
        ("flash_attention", "ssd_chunk"), local_batch=HYBRID_BATCH,
        plain_f64={"flash_attention": flash_attention_plain_f64,
                   "ssd_chunk": ssd_chunk_plain_f64})
    release(dev)
    lap(10)
    paths["encoder"], encoder_gap = phase_visit(dev, 11, get_config("hubert-xlarge"),
                                                ENCODER_BATCH)
    release(dev)
    lap(11)
    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b"), num_layers=VLM_LAYERS,
                              vocab_size=VLM_VOCAB)
    paths["vlm"], vlm_gap = phase_visit(dev, 12, cfg, VLM_BATCH, gates=VLM_GATE)
    release(dev)
    lap(12)
    paths["async"], paths["async_hierarchical"] = run_phase_async(err)
    release(dev)
    lap(13)

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
        "hybrid_eval_logit_gap": hybrid_gap,
        "encoder_grad_gap_share": encoder_gap,
        "vlm_grad_gap_share": vlm_gap,
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
        "hybrid_eval_logit_gap": hybrid_gap,
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
        "collectives_per_call": main_row["sharded_collectives_per_call"],
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
