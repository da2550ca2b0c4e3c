"""SSD chunk (K7): the intra-chunk part of Mamba-2's chunked SSD scan.

Port of the reference's ``repro.kernels.ssd_scan`` (the Pallas TPU kernel
``_ssd_chunk_kernel``). For each (batch row, chunk, head), with
cum = cumsum(dt·a) over the chunk:

  * y_intra = ((C·Bᵀ) ∘ exp(cum_i − cum_j) ∘ [j ≤ i] ∘ dt_j)·x;
  * the chunk's terminal state Σ_j exp(cum_last − cum_j)·dt_j·x_j ⊗ b_j;
  * cum_last, the chunk's total log decay.

Pieces:

  * ``ssd_chunk`` — the forward on the model's own layout: x
    ``(B, NC, CL, NH, HP)``, dt ``(B, NC, CL, NH)``, a_neg ``(B, NH)`` (one
    row per batch row: under the cohort's vmap every client has its own
    ``A_log``), b and c ``(B, NC, CL, N)``, all f32. It returns y_intra
    ``(B, NC, CL, NH, HP)``, states ``(B, NC, NH, HP, N)`` and cum_last
    ``(B, NC, NH)``. A CPU tensor takes ``ssd_chunk_plain``; a CUDA tensor
    launches the sm_90a kernels of ``csrc/ssd_scan.cu`` (whose header gives
    their bound and design): C·Bᵀ once per (batch row, chunk), then every
    head's W·x and state on the tensor cores (3×TF32). There is no fallback
    from one to the other.
  * ``SSDChunk`` — the ``torch.autograd.Function`` around it, in the
    ``forward`` + ``setup_context`` form that ``torch.func`` accepts. Its
    backward is plain PyTorch (the reference differentiates its jnp
    ``_ssd_chunked``, never the Pallas kernel), recomputes each chunk's
    (CL, CL) weights from the saved inputs and runs without recording a
    graph (once differentiable); its ``vmap`` rule folds a
    vmapped client axis into the batch axis, so a vmapped cohort costs one
    launch per call.

Two choices differ from the Pallas kernel, both in the plain version and
the kernel alike:

  * The exponential is taken only where j ≤ i. The reference computes
    exp(cum_i − cum_j) for every (i, j) and masks afterwards; above the
    diagonal the exponent is positive, so past a log-decay spread of ~88 in
    one chunk it overflows to inf and inf·0 is NaN. Masking first keeps
    K7 finite wherever the exact recurrence (``ref.ssd_reference``) is.
  * cum is accumulated in f64 and each partial sum rounded to f32 once
    (``chunk_cumsum``). f64 sums of f32 terms of like magnitude are exact,
    so their order is free: the kernel's shuffle scan, the plain version's
    cumsum on either device and the cross-chunk correction in
    ``ops.ssd_forward`` see the same cum (the csrc header says when that
    holds). Summed in f32, a parallel prefix on the card and a sequential
    one on the CPU would round differently.

``ops.ssd_forward`` is the public entry. ``LAUNCHES["ssd_chunk"]`` counts
calls of K7 on the card (each launches its two kernels); the plain version
does not count.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels._math import exp as _exp

MAX_CHUNK = 256      # csrc kMaxChunk
MAX_HEAD_DIM = 128   # csrc kMaxHeadDim
MAX_STATE = 256      # csrc kMaxState
TILE = 64            # csrc kTile: the scratch of C·Bᵀ is (B·NC, CLP, CLP), CLP = CL
                     # rounded up to it

LAUNCHES = {"ssd_chunk": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load csrc/ssd_scan.cu, with its C types."""
    lib = _build.build("ssd_scan").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_chunk_forward.argtypes = [p] * 10 + [i] * 6 + [ll] * 16 + [p]
    lib.ssd_chunk_forward.restype = i
    lib.ssd_occupancy.argtypes = [i]
    lib.ssd_occupancy.restype = i
    lib.ssd_error_string.argtypes = [i]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def occupancy(head_dim: int) -> int:
    """CTAs of ``ssd_chunk_heads_kernel`` one SM of the current card holds at
    this head dim (builds the library on first use)."""
    return _library().ssd_occupancy(head_dim)


def _check(x, dt, a_neg, b, c) -> None:
    if x.dim() != 5 or dt.dim() != 4 or a_neg.dim() != 2 or b.dim() != 4 \
            or c.shape != b.shape:
        raise ValueError(
            f"want x (B, NC, CL, NH, HP), dt (B, NC, CL, NH), a_neg (B, NH) and b, c "
            f"(B, NC, CL, N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(a_neg.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    bsz, nc, cl, nh, hp = x.shape
    if dt.shape != (bsz, nc, cl, nh) or a_neg.shape != (bsz, nh) \
            or b.shape[:3] != (bsz, nc, cl):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, a_neg "
                         f"{tuple(a_neg.shape)} and b/c {tuple(b.shape)} disagree")
    for what, size, top in (("chunk length", cl, MAX_CHUNK), ("head dim", hp, MAX_HEAD_DIM),
                            ("state size", b.shape[3], MAX_STATE)):
        if not 1 <= size <= top:
            raise ValueError(f"{what} {size} is outside [1, {top}]")
    if any(t.dtype != torch.float32 for t in (x, dt, a_neg, b, c)):
        raise ValueError("x, dt, a_neg, b and c must all be float32; got "
                         f"{x.dtype}, {dt.dtype}, {a_neg.dtype}, {b.dtype}, {c.dtype}")
    if any(t.device != x.device for t in (dt, a_neg, b, c)):
        raise ValueError("x, dt, a_neg, b and c must lie on one device")


def to_chunks(x, dt, b_in, c_in, chunk: int):
    """(B,S,…) operands → K7's (B, NC, CL, …) layout, S zero-padded to a
    multiple of ``chunk`` (a view where no padding is needed)."""
    bsz, s = x.shape[:2]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    return (x.reshape(bsz, nc, chunk, *x.shape[2:]), dt.reshape(bsz, nc, chunk, -1),
            b_in.reshape(bsz, nc, chunk, -1), c_in.reshape(bsz, nc, chunk, -1))


def chunk_cumsum(da: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the chunk axis (dim -2 of (..., CL, NH)), summed
    in f64 and rounded to f32 once per entry, as the kernel sums it."""
    return torch.cumsum(da, dim=-2, dtype=torch.float64).to(torch.float32)


def _decay(cum: torch.Tensor) -> torch.Tensor:
    """(B, NC, CL, NH) cum → (B, NC, NH, CL, CL) exp(cum_i − cum_j) for
    j ≤ i and exactly 0 above the diagonal, the exponent masked first."""
    cl = cum.shape[2]
    cumh = cum.transpose(2, 3)
    causal = torch.ones(cl, cl, dtype=torch.bool, device=cum.device).tril()
    diff = cumh[..., :, None] - cumh[..., None, :]
    return _exp(torch.where(causal, diff, -torch.inf))


def _weights(x, dt, a_neg, b, c):
    """cum (B, NC, CL, NH), C·Bᵀ (B, NC, CL, CL), the masked decay and the
    weights W = (C·Bᵀ ∘ decay) ∘ dt_j, both (B, NC, NH, CL, CL)."""
    cum = chunk_cumsum(dt * a_neg[:, None, None, :])
    scores = torch.einsum("bcin,bcjn->bcij", c, b)
    decay = _decay(cum)
    w = scores[:, :, None] * decay * dt.transpose(2, 3)[..., None, :]
    return cum, scores, decay, w


def ssd_chunk_plain(x, dt, a_neg, b, c):
    """Plain version of K7, a transcription of ``_ssd_chunk_kernel`` for all
    (batch row, chunk, head) at once (exponent masked first, cum in f64:
    see the module docstring). Returns ``(y_intra, states, cum_last)``."""
    cum, _, _, w = _weights(x, dt, a_neg, b, c)
    y = torch.einsum("bchij,bcjhp->bcihp", w, x)
    v = _exp(cum[:, :, -1:] - cum) * dt                         # (B, NC, CL, NH)
    states = torch.einsum("bcjhp,bcjn->bchpn", x * v[..., None], b)
    return y, states, cum[:, :, -1]


def ssd_chunk_cuda(x, dt, a_neg, b, c):
    """K7 on the card: ``ssd_chunk_cb_kernel`` forms C·Bᵀ once per (batch
    row, chunk) and every head's cum, dt and v rows into scratch tensors,
    then ``ssd_chunk_heads_kernel`` forms every head's y_intra and state
    from them. Same contract as ``ssd_chunk_plain``; x, b and c must have a
    contiguous last dimension (every other stride is read as it is). The
    two launches are one call of K7: ``LAUNCHES["ssd_chunk"]`` counts 1."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_cuda takes CUDA tensors, got {x.device}")
    if any(t.stride(-1) != 1 for t in (x, b, c)):
        raise ValueError("the last dimension of x, b and c must be contiguous")
    _build.check_card(x.device)
    lib = _library()
    bsz, nc, cl, nh, hp = x.shape
    n = b.shape[-1]
    clp = -(-cl // TILE) * TILE
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((bsz, nc, cl, nh, hp), **f32)
    states = torch.empty((bsz, nc, nh, hp, n), **f32)
    cum_last = torch.empty((bsz, nc, nh), **f32)
    if bsz * nc * nh == 0:
        return y, states, cum_last
    scores = torch.empty((bsz * nc, clp, clp), **f32)   # C·Bᵀ, causal tiles
    rows = torch.empty((bsz * nc, nh, 3, clp), **f32)   # cum, dt and v per head
    rc = lib.ssd_chunk_forward(
        x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), states.data_ptr(), cum_last.data_ptr(), scores.data_ptr(),
        rows.data_ptr(),
        bsz, nc, cl, nh, hp, n,
        *x.stride()[:4], *dt.stride(), *a_neg.stride(), *b.stride()[:3], *c.stride()[:3],
        _build.stream(x.device))
    if rc != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error {rc} "
                           f"({lib.ssd_error_string(rc).decode()})")
    LAUNCHES["ssd_chunk"] += 1
    return y, states, cum_last


def ssd_chunk(x, dt, a_neg, b, c):
    """K7 forward: CPU tensors → ``ssd_chunk_plain``; CUDA tensors → the
    sm_90a kernel."""
    _check(x, dt, a_neg, b, c)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, a_neg, b, c)
    if x.device.type == "cuda":
        return ssd_chunk_cuda(x, dt, a_neg, b, c)
    raise ValueError(f"unsupported device {x.device}")


def ssd_recurrence(x, dt, a_neg, b_in, c_in, h0=None):
    """The exact sequential SSD recurrence (the definition, S steps), as the
    reference's ``ref.ssd_reference``: h ← exp(dt·a)·h + dt·x ⊗ b and
    y = c·h. x (B,S,NH,HP); dt (B,S,NH); a_neg (NH,); b/c (B,S,N); h0
    (B,NH,HP,N) or None. Returns (y (B,S,NH,HP), h_final). The oracle that
    K7 and ``ops.ssd_forward`` are held against; on no path of the port."""
    bsz, s, nh, hp = x.shape
    h = torch.zeros((bsz, nh, hp, b_in.shape[-1]), dtype=torch.float32,
                    device=x.device) if h0 is None else h0
    ys = []
    for t in range(s):
        dec = torch.exp(dt[:, t] * a_neg)
        h = dec[:, :, None, None] * h + torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t],
                                                     b_in[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", c_in[:, t], h))
    return torch.stack(ys, 1), h


# ---------------------------------------------------------------------------
# Backward (plain PyTorch) and the autograd.Function
# ---------------------------------------------------------------------------


def ssd_chunk_bwd(x, dt, a_neg, b, c, gy, gstates, gcum_last):
    """Gradients of ``ssd_chunk`` for x, dt, a_neg, b and c, from the saved
    inputs and the output gradients. With W_ij = S_ij·L_ij·dt_j (S = C·Bᵀ,
    L the masked decay) and v_j = exp(cum_last − cum_j)·dt_j:
    dW = dY·xᵀ, dx = Wᵀ·dY + v ∘ (dStates·b), dS = Σ_h dW ∘ L ∘ dt_j,
    dcum_i += Σ_j (dW ∘ W)_ij and dcum_j −= Σ_i (dW ∘ W)_ij, the state's
    terms likewise, and dcum back through the cumsum to dt and a."""
    cum, scores, decay, w = _weights(x, dt, a_neg, b, c)
    dth = dt.transpose(2, 3)                                    # (B, NC, NH, CL)
    xh = x.transpose(2, 3)                                      # (B, NC, NH, CL, HP)
    gw = torch.einsum("bcihp,bcjhp->bchij", gy, x)
    gx = torch.einsum("bchij,bcihp->bchjp", w, gy)
    t = gw * decay
    gscores = torch.einsum("bchij,bchj->bcij", t, dth)
    gdt = torch.einsum("bchij,bcij->bchj", t, scores)
    g = gw * w
    gcum = g.sum(-1) - g.sum(-2)                                # (B, NC, NH, CL)
    gc = torch.einsum("bcij,bcjn->bcin", gscores, b)
    gb = torch.einsum("bcij,bcin->bcjn", gscores, c)
    # The terminal state Σ_j v_j·x_j ⊗ b_j.
    cumh = cum.transpose(2, 3)
    e = _exp(cumh[..., -1:] - cumh)
    v = e * dth
    gsb = torch.einsum("bchpn,bcjn->bchjp", gstates, b)       # (B, NC, NH, CL, HP)
    gx = (gx + v[..., None] * gsb).transpose(2, 3)
    gv = (xh * gsb).sum(-1)
    gb = gb + torch.einsum("bchpn,bchjp->bcjn", gstates, xh * v[..., None])
    gdt = gdt + gv * e
    ev = gv * v
    tail = (ev.sum(-1) + gcum_last)[..., None]                  # into cum_last = cum[-1]
    gcum = torch.cat([gcum[..., :-1], gcum[..., -1:] + tail], -1) - ev
    gda = torch.flip(torch.cumsum(torch.flip(gcum, (-1,)), -1), (-1,))
    gdt = gdt + gda * a_neg[:, None, :, None]
    ga = (gda * dth).sum((1, 3))
    return gx, gdt.transpose(2, 3), ga, gb, gc


class SSDChunk(torch.autograd.Function):
    """K7 with a plain-PyTorch backward and a batch-folding vmap rule.

    ``apply(x, dt, a_neg, b, c)`` → ``(y_intra, states, cum_last)``, all
    differentiable. The device of the tensors picks the kernel or the plain
    version, so the backward and the vmap rule run the same on the CPU.
    """

    @staticmethod
    def forward(x, dt, a_neg, b, c):
        return ssd_chunk(x, dt, a_neg, b, c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gy, gstates, gcum_last):
        # torch.func.grad runs the backward with create_graph=True, which
        # would record this one too and keep its (B·NH, CL, CL) intermediates
        # (~2.9 GB per layer on the mamba2 path) alive until the step's
        # gradients are formed. Nothing differentiates twice.
        with torch.no_grad():
            return ssd_chunk_bwd(*ctx.saved_tensors, gy, gstates, gcum_last)

    @staticmethod
    def vmap(info, in_dims, x, dt, a_neg, b, c):
        n = info.batch_size
        args = [_build.fold_client_axis(t, d, n)
                for t, d in zip((x, dt, a_neg, b, c), in_dims)]
        outs = SSDChunk.apply(*args)
        return tuple(o.reshape(n, -1, *o.shape[1:]) for o in outs), (0, 0, 0)
