"""Grouped matmul (K6): the MoE expert products.

Port of the reference's ``repro.kernels.moe_gmm`` (the Pallas TPU kernel
``_gmm_kernel`` behind ``gmm_padded`` and ``grouped_matmul``), the grouped
matmul a deployment swaps in for the ``jax.lax.ragged_dot`` calls of
``models/moe.py``. For xs (M, K) sorted by group, rhs (G, K, N) and
group_sizes (G,), each row of group g is ``row(f32) @ rhs[g](f32)``,
accumulated in f32 and rounded once to xs's dtype; rows past the last group
are 0, as ``ragged_dot`` leaves them.

Pieces:

  * ``padded_layout`` — the reference's group-aligned padded layout
    (``grouped_matmul``'s prologue): ``dst``, ``padded_offs``,
    ``block_groups`` and ``m_pad``, equal to the reference's.
  * ``gmm_plain`` — the plain version: the rows scattered to that layout,
    each block multiplied by its group's matrix in f32 and rounded once, the
    rows gathered back, rows past the last group 0; ``gmm_plain_clients``
    runs it client by client over a folded cohort.
  * ``gmm_cuda`` — one launch of the sm_90a kernel of ``csrc/moe_gmm.cu``
    (whose header gives its bound and design; bf16 streams the weights
    through a TMA ring into ``mma.sync``, f32 runs an FMA loop). It reads
    the layout's blocks in place, and takes a cohort folded in: xs (C·R, K), group_sizes (C, G)
    and rhs (C, G, K, N), or (G, K, N) shared by the C clients, read through
    its strides; client c's expert g is group c·G + g.
  * ``grouped_matmul_fwd`` — CPU tensors take the plain version, CUDA
    tensors the kernel; there is no fallback from one to the other.
  * ``GroupedMatmul`` — the ``torch.autograd.Function`` around it, in the
    ``forward`` + ``setup_context`` form that ``torch.func`` accepts. Its
    ``vmap`` rule folds a vmapped cohort into one launch. Its backward (the
    reference has no backward kernel: XLA differentiates ``ragged_dot``)
    takes dX = dY·rhs[g]ᵀ through K6 itself on a transposed view of rhs,
    and dW[g] = X_gᵀ·dY_g as a masked contraction per static group
    (``gmm_rhs_grad``), both without recording a graph.

``ops.grouped_matmul`` is the public entry. ``LAUNCHES["grouped_matmul"]``
counts kernel launches; the plain version does not count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_M = 128   # the reference's block_m
MAX_BLOCK_M = 128       # csrc kMaxBlockM

LAUNCHES = {"grouped_matmul": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load csrc/moe_gmm.cu, with its C types."""
    lib = _build.build("moe_gmm").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gmm_forward.argtypes = [i, p, p, p, p] + [i] * 6 + [ll] * 5 + [p]
    lib.gmm_forward.restype = i
    lib.gmm_error_string.argtypes = [i]
    lib.gmm_error_string.restype = ctypes.c_char_p
    return lib


def padded_layout(group_sizes: torch.Tensor, m: int, block_m: int = DEFAULT_BLOCK_M):
    """The reference's group-aligned layout for M rows in G groups: each
    group's segment padded to a multiple of ``block_m``. Returns ``(dst (M,)
    padded row of each row, padded_offs (G+1,), block_groups (M_pad /
    block_m,) group of each block, m_pad)``, int32 as the reference's."""
    g = group_sizes.shape[0]
    dev = group_sizes.device
    sizes = group_sizes.to(torch.int64)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    padded_offs = torch.cat([zero, torch.cumsum((sizes + block_m - 1) // block_m * block_m, 0)])
    offs = torch.cat([zero, torch.cumsum(sizes, 0)])
    # worst case every group pads to a full extra block
    m_pad = -(-(m + g * block_m) // block_m) * block_m
    row = torch.arange(m, device=dev)
    grp = torch.searchsorted(offs[1:], row, right=True)
    dst = padded_offs[grp] + (row - offs[grp])
    blk = torch.arange(m_pad // block_m, device=dev)
    block_groups = torch.clamp(torch.searchsorted(padded_offs[1:], blk * block_m, right=True),
                               0, g - 1)
    return (dst.to(torch.int32), padded_offs.to(torch.int32), block_groups.to(torch.int32),
            m_pad)


def _check(xs, rhs, group_sizes, block_m: int) -> int:
    """Raise on operands K6 does not take; return the client count C."""
    if xs.dim() != 2 or rhs.dim() not in (3, 4) or group_sizes.dim() not in (1, 2):
        raise ValueError(f"want xs (M, K), rhs (G, K, N) or (C, G, K, N) and group_sizes "
                         f"(G,) or (C, G); got {tuple(xs.shape)}, {tuple(rhs.shape)}, "
                         f"{tuple(group_sizes.shape)}")
    clients = group_sizes.shape[0] if group_sizes.dim() == 2 else 1
    g, k = rhs.shape[-3], rhs.shape[-2]
    if group_sizes.shape[-1] != g or xs.shape[1] != k or xs.shape[0] % clients \
            or (rhs.dim() == 4 and rhs.shape[0] != clients):
        raise ValueError(f"xs {tuple(xs.shape)}, rhs {tuple(rhs.shape)} and group_sizes "
                         f"{tuple(group_sizes.shape)} disagree")
    if xs.dtype != rhs.dtype or xs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xs and rhs must both be float32 or both bfloat16; got "
                         f"{xs.dtype}, {rhs.dtype}")
    if group_sizes.dtype != torch.int32:
        raise ValueError(f"group_sizes must be int32, got {group_sizes.dtype}")
    if rhs.device != xs.device or group_sizes.device != xs.device:
        raise ValueError("xs, rhs and group_sizes must lie on one device")
    if not 1 <= block_m <= MAX_BLOCK_M:
        raise ValueError(f"block_m {block_m} is outside [1, {MAX_BLOCK_M}]")
    return clients


def gmm_plain(xs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
              block_m: int = DEFAULT_BLOCK_M) -> torch.Tensor:
    """Plain version of K6 for one client: xs (M, K), rhs (G, K, N),
    group_sizes (G,). The reference's ``grouped_matmul`` step by step (rows
    scattered to the padded layout, each block times its group's matrix, rows
    gathered back), each block in f32 (f64 for f64 operands) and rounded
    once; blocks past the last group are skipped and rows past the last
    group are 0."""
    m, k = xs.shape
    g, _, n = rhs.shape
    dst, padded_offs, block_groups, m_pad = padded_layout(group_sizes, m, block_m)
    dst = dst.to(torch.int64)
    lhs = torch.zeros((m_pad, k), dtype=xs.dtype, device=xs.device).index_copy(0, dst, xs)
    blocks = lhs.view(m_pad // block_m, block_m, k)
    out = torch.zeros((m_pad // block_m, block_m, n), dtype=xs.dtype, device=xs.device)
    live = torch.arange(m_pad // block_m, device=xs.device) * block_m < padded_offs[-1]
    acc_dtype = torch.promote_types(xs.dtype, torch.float32)
    for gi in range(g):
        sel = torch.nonzero(live & (block_groups == gi)).squeeze(1)
        if sel.numel():
            out[sel] = (blocks[sel].to(acc_dtype) @ rhs[gi].to(acc_dtype)).to(xs.dtype)
    out = out.view(m_pad, n)[dst]
    in_group = torch.arange(m, device=xs.device) < group_sizes.sum()
    return torch.where(in_group[:, None], out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device))


def gmm_plain_clients(xs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
                      block_m: int = DEFAULT_BLOCK_M) -> torch.Tensor:
    """``gmm_plain`` client by client over ``gmm_cuda``'s folded operands:
    xs (C·R, K), rhs (C, G, K, N) or shared (G, K, N), group_sizes (C, G) or
    (G,). The same function as one launch of K6, on any device."""
    clients = _check(xs, rhs, group_sizes, block_m)
    sizes = group_sizes.reshape(clients, -1)
    rows = xs.shape[0] // clients
    return torch.cat([
        gmm_plain(xs[c * rows:(c + 1) * rows], rhs[c] if rhs.dim() == 4 else rhs, sizes[c],
                  block_m=block_m) for c in range(clients)])


def gmm_cuda(xs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
             block_m: int = DEFAULT_BLOCK_M) -> torch.Tensor:
    """K6 on the card: one launch of the kernel for C clients (C = 1 for a
    (G,) group_sizes). xs (C·R, K) with a contiguous last dimension,
    group_sizes (C, G) int32 contiguous, rhs (C, G, K, N) or (G, K, N) read
    through its strides. Returns (C·R, N) in xs's dtype."""
    if xs.device.type != "cuda":
        raise ValueError(f"gmm_cuda takes CUDA tensors, got {xs.device}")
    clients = _check(xs, rhs, group_sizes, block_m)
    if xs.stride(1) != 1:
        raise ValueError("the last dimension of xs must be contiguous")
    if not group_sizes.is_contiguous():
        raise ValueError("group_sizes must be contiguous")
    _build.check_card(xs.device)
    lib = _library()
    m, k = xs.shape
    g, _, n = rhs.shape[-3:]
    out = torch.empty((m, n), dtype=xs.dtype, device=xs.device)
    if m == 0 or n == 0:
        return out
    rc = rhs.stride(0) if rhs.dim() == 4 else 0
    rg, rk, rn = rhs.stride()[-3:]
    rc_ = lib.gmm_forward({torch.float32: 0, torch.bfloat16: 1}[xs.dtype],
                          xs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
                          out.data_ptr(), clients, g, m // clients, k, n, block_m,
                          xs.stride(0), rc, rg, rk, rn, _build.stream(xs.device))
    if rc_ != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA error {rc_} "
                           f"({lib.gmm_error_string(rc_).decode()})")
    LAUNCHES["grouped_matmul"] += 1
    return out


def grouped_matmul_fwd(xs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
                       block_m: int = DEFAULT_BLOCK_M) -> torch.Tensor:
    """K6 forward over C clients (see ``gmm_cuda``): CPU tensors →
    ``gmm_plain_clients``; CUDA tensors → the sm_90a kernel."""
    if xs.device.type == "cpu":
        return gmm_plain_clients(xs, rhs, group_sizes, block_m=block_m)
    if xs.device.type == "cuda":
        return gmm_cuda(xs, rhs, group_sizes, block_m=block_m)
    raise ValueError(f"unsupported device {xs.device}")


def gmm_rhs_grad(xs: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """dW[g] = X_gᵀ·dY_g for xs (M, K), dy (M, N), group_sizes (G,): one
    product over all M rows per group, the rows of other groups masked to 0
    (vmap cannot slice a data-dependent segment). The mask goes on the
    narrower operand. Returns (G, K, N) in xs's dtype."""
    m = xs.shape[0]
    ends = torch.cumsum(group_sizes, 0)
    row = torch.arange(m, device=xs.device)
    grp = (row[:, None] >= ends[None, :]).sum(1)   # G for rows past the last group
    mask_x = xs.shape[1] <= dy.shape[1]
    out = []
    for g in range(group_sizes.shape[-1]):
        keep = (grp == g)[:, None]
        if mask_x:
            out.append(torch.where(keep, xs, 0).mT @ dy)
        else:
            out.append(xs.mT @ torch.where(keep, dy, 0))
    return torch.stack(out)


class GroupedMatmul(torch.autograd.Function):
    """K6 with a batch-folding vmap rule and a backward of K6 (dX) and a
    plain masked contraction (dW).

    ``apply(xs, rhs, group_sizes, block_m)`` → (M, N). The device of the
    tensors picks the kernel or the plain version, so the backward and the
    vmap rule run the same on the CPU.
    """

    @staticmethod
    def forward(xs, rhs, group_sizes, block_m: int):
        return grouped_matmul_fwd(xs.contiguous(), rhs, group_sizes.contiguous(),
                                  block_m=block_m)

    @staticmethod
    def setup_context(ctx, inputs, output):
        xs, rhs, group_sizes, block_m = inputs
        ctx.save_for_backward(xs, rhs, group_sizes)
        ctx.block_m = block_m

    @staticmethod
    def backward(ctx, dy):
        xs, rhs, group_sizes = ctx.saved_tensors
        dx = drhs = None
        # torch.func.grad runs the backward with create_graph=True; nothing
        # differentiates twice, so record nothing (see kernels/ssd_scan.py).
        with torch.no_grad():
            if ctx.needs_input_grad[0]:
                dx = GroupedMatmul.apply(dy, rhs.transpose(-1, -2), group_sizes, ctx.block_m)
            if ctx.needs_input_grad[1]:
                if rhs.dim() != 3:
                    raise NotImplementedError("the rhs gradient of a folded cohort call")
                drhs = gmm_rhs_grad(xs, dy, group_sizes).to(rhs.dtype)
        return dx, drhs, None, None

    @staticmethod
    def vmap(info, in_dims, xs, rhs, group_sizes, block_m):
        n = info.batch_size
        xd, rd, sd = in_dims[:3]
        if xs.dim() - (xd is not None) != 2 or rhs.dim() - (rd is not None) != 3 \
                or group_sizes.dim() - (sd is not None) != 1:
            raise ValueError("a vmapped GroupedMatmul takes xs (M, K), rhs (G, K, N) "
                             "and group_sizes (G,) per client")
        xs = _build.fold_client_axis(xs, xd, n)
        if rd is not None:                # (C, G, K, N) view; else shared, client stride 0
            rhs = rhs.movedim(rd, 0)
        sizes = group_sizes.movedim(sd, 0) if sd is not None \
            else group_sizes.expand(n, *group_sizes.shape)
        out = GroupedMatmul.apply(xs, rhs, sizes.contiguous(), block_m)
        return out.reshape(n, -1, out.shape[-1]), 0
