#!/usr/bin/env python3
"""Time textual variants of K7's source (src/repro_torch/kernels/csrc/ssd_scan.cu)
on one NVIDIA card.

    python3 scripts/k7_variants.py [scripts/k7_variants.json]

The JSON file maps a variant's name to a list of [old, new] replacements,
applied to ssd_scan.cu with csrc/hopper.cuh pasted in place of its include
(each old text must occur). Every variant is built with the library's own
nvcc flags into src/repro_torch/kernels/build/, loaded with ctypes and
called through ``ssd_scan.ssd_chunk`` at two shapes: the mamba2 path's
(B 32, CL 256, NH 32, HP 64, N 128) and HP 128. One JSON line per variant:
CUDA-event ms per call, the largest error against the plain version in f32
and in f64 (y_intra, states, cum_last), whether the outputs equal the first
variant's bitwise, and the heads kernel's CTAs per SM. A variant that only
times (it skips work) reports its errors all the same. Exits nonzero without
a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {"path": (32, 256, 256, 32, 64, 128), "hp128": (8, 256, 256, 32, 128, 128)}


def build(name, subs, src, out_dir):
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name}: text not found: {old[:60]!r}")
        src = src.replace(old, new)
    from repro_torch.kernels import _build

    cu = out_dir / f"k7_variant_{name}.cu"
    so = out_dir / f"libk7_variant_{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"variant {name} did not build:\n{proc.stderr[-4000:]}")
    return so


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k7_variants: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as tssd

    spec = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "scripts" / "k7_variants.json"
    variants = json.loads(spec.read_text())
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    src = (csrc / "ssd_scan.cu").read_text().replace(
        '#include "hopper.cuh"', (csrc / "hopper.cuh").read_text().replace("#pragma once", ""))
    out_dir = _build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(variants)) as pool:   # one nvcc each, together
        libs = dict(zip(variants, pool.map(lambda kv: build(*kv, src, out_dir),
                                           variants.items())))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)

    dev = torch.device("cuda")
    inputs, plain, exact = {}, {}, {}
    for key, (bsz, s, cl, nh, hp, n) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(1)
        r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        x, dt = r(bsz, s, nh, hp), torch.nn.functional.softplus(-2.0 + 0.5 * r(bsz, s, nh))
        a, b, c = -torch.exp(0.3 * r(nh)), r(bsz, s, n), r(bsz, s, n)
        xc, dtc, bc, cc = tssd.to_chunks(x, dt, b, c, cl)
        inputs[key] = (xc, dtc, a.expand(bsz, nh), bc, cc)
        plain[key] = tssd.ssd_chunk_plain(*inputs[key])
        exact[key] = tssd.ssd_chunk_plain(*(t.double() for t in inputs[key]))
    print(json.dumps({"plain_f32_vs_f64": {
        k: [float((p.double() - e).abs().max()) for p, e in zip(plain[k], exact[k])]
        for k in SHAPES}}), flush=True)

    def time_ms(fn, iters=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    first = {}
    library = tssd._library
    try:
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            for fn in ("ssd_chunk_forward", "ssd_occupancy", "ssd_error_string"):  # C types
                getattr(lib, fn).argtypes = getattr(library(), fn).argtypes
                getattr(lib, fn).restype = getattr(library(), fn).restype
            tssd._library = lambda lib=lib: lib
            row = {"variant": name, "ctas_per_sm_hp64": lib.ssd_occupancy(64)}
            for key, args in inputs.items():
                got = tssd.ssd_chunk(*args)
                torch.cuda.synchronize()
                ref = first.setdefault(key, got)
                row[key] = {
                    "ms": time_ms(lambda: tssd.ssd_chunk(*args)),
                    "err_vs_plain": [float((g - p).abs().max()) for g, p in zip(got, plain[key])],
                    "err_vs_f64": [float((g.double() - e).abs().max())
                                   for g, e in zip(got, exact[key])],
                    "bitwise_first": all(torch.equal(g, f) for g, f in zip(got, ref))}
            print(json.dumps(row), flush=True)
    finally:
        tssd._library = library
    return 0


if __name__ == "__main__":
    sys.exit(main())
