"""Build and load the CUDA kernel libraries from ``csrc/`` on first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``. The build goes into
``kernels/build/`` (listed in ``.gitignore``) under a name keyed by the hash
of the source, the shared headers and the flags, so a changed source is
rebuilt and an unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# No --use_fast_math: the scores use expf, log1pf and IEEE division.
# --fmad=false keeps each multiply and add rounded on its own, as the plain
# PyTorch versions compute them.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float      # compile time of this process's build; 0 if reused
    log: str            # nvcc/ptxas output of the build that made ``path``


def check_card(device) -> None:
    """Raise unless ``device`` is a Hopper card (sm_90), the kernels' target."""
    import torch

    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is sm_{major}{minor}")


def stream(device) -> int:
    """The current CUDA stream of ``device``, as the int the C entries take."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def fold_client_axis(x, dim, n: int):
    """For a kernel's ``autograd.Function.vmap`` rule: move the vmapped axis
    (or broadcast an unbatched input) to the front and fold it into the
    batch axis, (n, B, ...) → (n·B, ...), so one launch covers the cohort."""
    x = x.movedim(dim, 0) if dim is not None else x.expand(n, *x.shape)
    return x.reshape(n * x.shape[1], *x.shape[2:])


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no nvcc "
                           "on PATH); the kernels cannot be built")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


@functools.cache
def build(name: str) -> Built:
    """Compile (or reuse) ``csrc/<name>.cu`` and load it; the key covers the
    shared headers ``csrc/*.cuh`` too."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed to build {src.name}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, so)  # atomic: a concurrent builder sees all or nothing
        seconds = time.perf_counter() - t0
    log = log_path.read_text() if log_path.exists() else ""
    return Built(lib=ctypes.CDLL(str(so)), path=so, seconds=seconds, log=log)
