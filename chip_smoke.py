#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

  1. Device and build: the card's name and power limit (nvidia-smi), then
     the sm_90a build of the fused HeteRo-Select kernels K1–K4 from
     src/repro_torch/kernels/csrc/, with its ptxas report.
  2. Kernels against their plain PyTorch versions on the card, f32 and bf16
     state, staleness override off and on: K1 + K2 for K ∈ {12, 4133, 2^20}
     and m ∈ {6, 64, 1024} (m ≤ K), selected sets equal; K3 for the same K;
     K4 for the edge layouts in K4_CASES, padding slots exactly 0.0. Scores
     and probabilities must agree to 1e-5 relative. Then each kernel and its
     plain version are timed: CUDA events around back-to-back calls (what a
     caller waits, host dispatch included) and torch.profiler's device time.
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
  5. A JSON line of per-kernel numbers, then the result line.

It needs one card, imports nothing of JAX or of the reference package, and
exits nonzero without printing a result when torch sees no CUDA device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
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


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    tss.reset_launches()
    t0 = time.perf_counter()
    res = run_federated(model, fed, data, selector="heterosel_pallas",
                        steps_per_round=4, client_execution="batched",
                        device=dev, noise=noise, hooks=[CheckRound()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tss.LAUNCHES)

    if launches != {"score_stats": fed.rounds, "score_select": fed.rounds,
                    "score_probs": 0, "segment_probs": 0}:
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
    tss.reset_launches()
    t0 = time.perf_counter()
    res = run_federated(model, fed, data, selector="heterosel_pallas",
                        steps_per_round=4, client_execution="batched", device=dev,
                        hier_cfg=hcfg, edge_noise=edge_noise, hooks=[check])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tss.LAUNCHES)

    if launches != {"score_stats": 0, "score_select": 0, "score_probs": 0,
                    "segment_probs": fed.rounds}:
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)

    t0 = time.perf_counter()
    built = _build.build("score_select")
    print(f"phase 1: built {built.path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {built.seconds:.2f} s)", flush=True)
    print(built.log.strip(), flush=True)

    err, timings = phase_kernels(dev)
    flat = phase_main_path(dev)
    hier = phase_hierarchy(dev, err)

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
            "launches": flat[name] + hier[name],
            "launches_by_path": {"flat": flat[name], "hierarchical": hier[name]},
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
    print(json.dumps({"kernels": kernels, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
