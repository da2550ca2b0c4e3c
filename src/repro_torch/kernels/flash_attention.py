"""Flash attention (K5): blockwise online-softmax attention with f32 state.

Port of the reference's ``repro.kernels.flash_attention`` (the Pallas TPU
kernel ``_flash_kernel``), whose function is the reference's
``models.attention.blockwise_attention``:

  * ``flash_attention_fwd`` — the forward on the model's own layout, q
    ``(B, S, H, D)`` and k, v ``(B, T, KVH, D)``, returning o ``(B, S, H, D)``
    in q's dtype and the f32 row log-sum-exp ``(B, H, S)``. A CPU tensor
    takes ``flash_attention_plain``; a CUDA tensor launches the sm_90a
    kernel of ``csrc/flash_attention.cu`` (whose header gives its bound and
    design): for bf16 the tensor-core kernel ``flash_fwd_kernel_wgmma``
    (TMA-fed 64-key tiles, a KV head's query heads packed into one tile),
    for f32 the CUDA-core ``flash_fwd_kernel``. There is no fallback from
    one to the other.
  * ``FlashAttention`` — the ``torch.autograd.Function`` around it, in the
    ``forward`` + ``setup_context`` form that ``torch.func`` accepts. Its
    backward is plain PyTorch (the reference differentiates its jnp
    attention, never the Pallas kernel), and its ``vmap`` rule folds a
    vmapped client axis into the batch axis, so a vmapped cohort costs one
    launch per call, not one per client.

``ops.flash_mha`` is the public entry. ``LAUNCHES["flash_attention"]``
counts kernel launches; the plain version does not count.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

BLOCK_Q = 32        # query rows per CTA of the f32 kernel (csrc kBlockQ)
BLOCK_K = 32        # keys per kv tile of the f32 kernel (csrc kBlockK); the bf16
                    # kernel's 64-key tiles differ from it only in summation order
MAX_HEAD_DIM = 256
NEG_INF = -1e30     # finite, as in the reference: see csrc/flash_attention.cu
LOG2E = 1.4426950408889634
BWD_BLOCK_K = 256   # keys per tile of the plain backward

LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load csrc/flash_attention.cu, with its C types."""
    lib = _build.build("flash_attention").lib
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.fa_forward.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i,
                               ll, ll, ll, ll, ll, ll, ll, ll, ll, f, i, i, p]
    lib.fa_forward.restype = i
    lib.fa_error_string.argtypes = [i]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, S, H, D) and k, v (B, T, KVH, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree "
                         "(batch, head_dim, or H not a multiple of KVH)")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} is outside [1, {MAX_HEAD_DIM}]")
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in (torch.float32,
                                                                   torch.bfloat16):
        raise ValueError(f"q, k, v must all be float32 or all bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


# ---------------------------------------------------------------------------
# Forward: plain version and kernel
# ---------------------------------------------------------------------------


def _groups(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """(B, S, H, D) → (B, S, KVH, G, D): query head h = kvh·G + g reads KV head
    h // G, as the kernel reads it (no repeat of K and V)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, kvh, h // kvh, d)


def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp for the plain path. On the CPU it is 2^(x·log2 e) in f64, rounded
    once to x's dtype: ``torch.exp`` and ``torch.log`` of a CPU tensor run
    MKL's vector math library (VML), whose first call on several intra-op
    threads at once can compute one thread's share with ~1e-4 relative error
    (queue 3 (f); ``tests/test_torch_flash_threads.py --torch-only``).
    ``torch.exp2`` and ``torch.special.xlogy`` do not go through VML."""
    if x.device.type != "cpu":
        return torch.exp(x)
    return torch.exp2(x.double() * LOG2E).to(x.dtype)


def _log(x: torch.Tensor) -> torch.Tensor:
    """log for the plain path; on the CPU without VML, as ``_exp``."""
    if x.device.type != "cpu":
        return torch.log(x)
    return torch.special.xlogy(1.0, x.double()).to(x.dtype)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, t: int, causal: bool,
          window: int) -> torch.Tensor:
    """(S, Tc) validity of each (query, key) pair, as the reference masks."""
    mask = (k_pos < t)[None, :].expand(len(q_pos), -1)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool, window: int = 0):
    """Plain version of K5, with the f32 kernel's blocking: kv tiles of
    BLOCK_K keys in order, each row updating its f32 (m, l, acc) per tile,
    and a row of query tile i skipping the causally dead tiles its CTA skips
    (skipped tiles add exactly nothing, so other blockings differ only in
    summation order). Returns
    ``(o (B, S, H, D) in q.dtype, lse (B, H, S) f32)``."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qf = _groups(q.to(torch.float32) * (1.0 / math.sqrt(d)), kvh)  # (B,S,KVH,G,D)
    q_pos = torch.arange(s, device=q.device)
    # Last kv tile each query row's CTA runs (exclusive), as the kernel's kt_end.
    n_kv = -(-t // BLOCK_K)
    kt_end = torch.clamp_max((q_pos // BLOCK_Q * BLOCK_Q + BLOCK_Q - 1) // BLOCK_K + 1, n_kv) \
        if causal else torch.full_like(q_pos, n_kv)
    g = h // kvh
    m = torch.full((b, kvh, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, s, d), dtype=torch.float32, device=q.device)
    for kt in range(n_kv):
        j0 = kt * BLOCK_K
        k_pos = j0 + torch.arange(BLOCK_K, device=q.device)
        kc = k[:, j0:j0 + BLOCK_K].to(torch.float32)
        vc = v[:, j0:j0 + BLOCK_K].to(torch.float32)
        if kc.shape[1] < BLOCK_K:   # the ragged last tile: zero keys, masked
            pad = (0, 0, 0, 0, 0, BLOCK_K - kc.shape[1])
            kc = torch.nn.functional.pad(kc, pad)
            vc = torch.nn.functional.pad(vc, pad)
        sc = torch.einsum("bskgd,btkd->bkgst", qf, kc)
        sc = torch.where(_mask(q_pos, k_pos, t, causal, window), sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = _exp(sc - m_new[..., None])
        corr = _exp(m - m_new)
        live = kt < kt_end                                   # (S,)
        l = torch.where(live, l * corr + p.sum(-1), l)
        acc = torch.where(live[:, None], acc * corr[..., None]
                          + torch.einsum("bkgst,btkd->bkgsd", p, vc), acc)
        m = torch.where(live, m_new, m)
    lc = torch.clamp_min(l, 1e-30)
    o = (acc / lc[..., None]).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    lse = (m + _log(lc)).reshape(b, h, s)
    return o.to(q.dtype), lse


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool, window: int = 0):
    """K5 on the card: one launch of ``flash_fwd_kernel_wgmma`` (bf16) or
    ``flash_fwd_kernel`` (f32). Same contract as ``flash_attention_plain``;
    operands must be CUDA tensors with a contiguous last dimension, read
    through their other strides."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda takes CUDA tensors, got {q.device}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("the last dimension of q, k and v must be contiguous")
    _build.check_card(q.device)
    lib = _library()
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if b * s * h == 0:
        return o, lse
    rc = lib.fa_forward({torch.float32: 0, torch.bfloat16: 1}[q.dtype],
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        lse.data_ptr(), b, s, t, h, kvh, d,
                        q.stride(0), q.stride(1), q.stride(2),
                        k.stride(0), k.stride(1), k.stride(2),
                        v.stride(0), v.stride(1), v.stride(2),
                        1.0 / math.sqrt(d), int(causal), int(window),
                        _build.stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc} "
                           f"({lib.fa_error_string(rc).decode()})")
    LAUNCHES["flash_attention"] += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0):
    """K5 forward: CPU tensors → ``flash_attention_plain``; CUDA tensors →
    the sm_90a kernel."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    raise ValueError(f"unsupported device {q.device}")


# ---------------------------------------------------------------------------
# Backward (plain PyTorch) and the autograd.Function
# ---------------------------------------------------------------------------


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool, window: int = 0):
    """Attention backward from the saved forward, tile by tile over the keys:
    P = exp(S − lse), dP = dO·Vᵀ, dS = P ∘ (dP − rowsum(dO ∘ O)),
    dV = Pᵀ·dO, dK = dSᵀ·Q̂ and dQ = dS·K/√D (Q̂ = Q/√D), each group's query
    heads summed into its KV head. f32 inside; gradients in the inputs'
    dtypes."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = _groups(q.to(torch.float32) * scale, kvh)               # (B,S,KVH,G,D)
    dof = _groups(do.to(torch.float32), kvh)
    delta = torch.einsum("bskgd,bskgd->bkgs", dof, _groups(o.to(torch.float32), kvh))
    lse = lse.reshape(b, kvh, h // kvh, s)
    q_pos = torch.arange(s, device=q.device)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j0 in range(0, t, BWD_BLOCK_K):
        kc = k[:, j0:j0 + BWD_BLOCK_K].to(torch.float32)
        vc = v[:, j0:j0 + BWD_BLOCK_K].to(torch.float32)
        k_pos = j0 + torch.arange(kc.shape[1], device=q.device)
        sc = torch.einsum("bskgd,btkd->bkgst", qf, kc)
        sc = torch.where(_mask(q_pos, k_pos, t, causal, window), sc, NEG_INF)
        p = _exp(sc - lse[..., None])
        dp = torch.einsum("bskgd,btkd->bkgst", dof, vc)
        ds = p * (dp - delta[..., None])
        dvs.append(torch.einsum("bkgst,bskgd->btkd", p, dof))
        dks.append(torch.einsum("bkgst,bskgd->btkd", ds, qf))
        dq = dq + torch.einsum("bkgst,btkd->bskgd", ds, kc)
    dq = (dq * scale).reshape(b, s, h, d)
    return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype), torch.cat(dvs, 1).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """K5 with a plain-PyTorch backward and a batch-folding vmap rule.

    ``apply(q, k, v, causal, window)`` → ``(o, lse)``; only ``o`` is
    differentiable. The device of the tensors picks the kernel or the plain
    version, so the backward and the vmap rule run the same on the CPU.
    """

    @staticmethod
    def forward(q, k, v, causal: bool, window: int):
        return flash_attention_fwd(q, k, v, causal=causal, window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        n = info.batch_size
        qd, kd, vd = in_dims[:3]
        fold = _build.fold_client_axis
        o, lse = FlashAttention.apply(fold(q, qd, n), fold(k, kd, n),
                                      fold(v, vd, n), causal, window)
        return (o.reshape(n, -1, *o.shape[1:]), lse.reshape(n, -1, *lse.shape[1:])), (0, 0)
