"""K6, the grouped matmul of the MoE FFN: the port's layout, plain version
and ``ops.grouped_matmul`` against the reference.

The reference is ``repro.kernels.moe_gmm.grouped_matmul`` (the Pallas kernel
run with ``interpret=True``), its oracle ``ref.gmm_reference`` and
``jax.lax.ragged_dot``, which the reference model calls. Shapes and group
distributions are those of ``tests/test_extensions.py::TestGroupedMatmulKernel``.
Inputs are drawn with numpy from a seed and handed to both packages.

Tolerances:
  * The padded layout (``dst``, ``padded_offs``, ``block_groups``) is equal.
  * Forward in f32: 1e-5 relative plus 1e-5 of the largest entry; the two
    packages sum each row's f32 products in their own order (measured: 0).
  * Forward in bf16: both round an f32 sum once, so at most one bf16 ulp
    apart where the f32 sums differ in the last bit (measured: 0).
  * Gradients against ``jax.grad`` of ``ragged_dot``: f32 1e-5 of each
    gradient's largest entry (sum order); bf16 one bf16 ulp of the entry plus
    1e-2 of the largest entry (dW is one bf16 matmul per group here, XLA's
    transpose of ``ragged_dot`` there; both round once from f32 sums).
  * The vmap fold against a per-client loop: bitwise (same plain products).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import moe_gmm as jgmm
from repro.kernels.ref import gmm_reference
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ops

from test_torch_flash import bf16_ulp, np32
from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)

# (M, K, N, G, block_m) of the reference's TestGroupedMatmulKernel
SHAPES = [(64, 32, 64, 4, 16), (100, 16, 32, 3, 8), (256, 64, 128, 8, 32)]
SHAPE_IDS = ["m64-bm16", "m100-uneven-bm8", "m256-bm32"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files on parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def draw(m, k, n, g, seed, sizes=None):
    rng = np.random.default_rng(seed)
    if sizes is None:
        sizes = rng.multinomial(m, np.ones(g) / g)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(g, k, n)).astype(np.float32), np.asarray(sizes, np.int32))


def both(xs, rhs, sizes, dtype):
    """Torch and jnp copies of the operands in ``dtype`` ("float32"/"bfloat16")."""
    tdt = getattr(torch, dtype)
    t = (torch.from_numpy(xs).to(tdt), torch.from_numpy(rhs).to(tdt), torch.from_numpy(sizes))
    j = (jnp.asarray(xs).astype(dtype), jnp.asarray(rhs).astype(dtype), jnp.asarray(sizes))
    return t, j


def assert_forward_close(got, want, dtype):
    g, w = np32(got), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    else:
        assert np.all(np.abs(g - w) <= bf16_ulp(np.abs(w))), np.abs(g - w).max()


@pytest.mark.parametrize("m,k,n,g,bm", SHAPES, ids=SHAPE_IDS)
def test_padded_layout_equals_reference(m, k, n, g, bm, monkeypatch):
    """The reference's prologue, read off what it hands ``gmm_padded``: row i
    of xs carries i, so the scattered lhs shows where each row went."""
    xs, rhs, sizes = draw(m, k, n, g, m + g, sizes=None)
    sizes[1] = 0                                     # an empty group too
    sizes[0] = m - sizes[1:].sum()
    xs[:, 0] = np.arange(m) + 1
    seen = {}

    def capture(lhs, rhs_, block_groups, **kw):
        seen.update(lhs=np.asarray(lhs), block_groups=np.asarray(block_groups))
        return jnp.zeros((lhs.shape[0], rhs_.shape[-1]), lhs.dtype)

    monkeypatch.setattr(jgmm, "gmm_padded", capture)
    jgmm.grouped_matmul(jnp.asarray(xs), jnp.asarray(rhs), jnp.asarray(sizes), block_m=bm)
    dst, padded_offs, block_groups, m_pad = tgmm.padded_layout(torch.from_numpy(sizes), m, bm)
    assert dst.dtype == padded_offs.dtype == block_groups.dtype == torch.int32
    assert m_pad == seen["lhs"].shape[0]
    np.testing.assert_array_equal(block_groups.numpy(), seen["block_groups"])
    want_dst = np.full(m, -1)
    nz = np.flatnonzero(seen["lhs"][:, 0])
    want_dst[seen["lhs"][nz, 0].astype(int) - 1] = nz
    np.testing.assert_array_equal(dst.numpy(), want_dst)
    padded = -(-sizes // bm) * bm
    np.testing.assert_array_equal(padded_offs.numpy(), np.concatenate([[0], np.cumsum(padded)]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,g,bm", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_pallas_kernel_and_oracle(m, k, n, g, bm, dtype):
    (txs, trhs, tsz), (jxs, jrhs, jsz) = both(*draw(m, k, n, g, m + g), dtype)
    got = tgmm.gmm_plain(txs, trhs, tsz, block_m=bm)
    assert got.dtype == txs.dtype and got.shape == (m, n)
    kernel = jgmm.grouped_matmul(jxs, jrhs, jsz, block_m=bm, block_n=min(n, 64),
                                 interpret=True)
    assert_forward_close(got, kernel, dtype)
    assert_forward_close(got, gmm_reference(jxs, jrhs, jsz), dtype)
    # The autograd entry outside vmap is the same function.
    np.testing.assert_array_equal(np32(ops.grouped_matmul(txs, trhs, tsz, block_m=bm)),
                                  np32(got))


@pytest.mark.parametrize("sizes,bm", [([0, 5, 0, 11], 8), ([10, 22, 0, 32], 16),
                                      ([0, 0, 64, 0], 16), ([7, 0, 20, 0], 8)],
                         ids=["empty-groups", "ragged-dot", "one-group-all-rows",
                              "rows-past-last-group"])
def test_plain_matches_ragged_dot(sizes, bm):
    """Empty groups, one group with every row, and rows past the last group
    (0, as ``ragged_dot`` leaves them; the reference's ``grouped_matmul``
    would multiply them by the last group's matrix)."""
    m = 64 if sum(sizes) > 16 else 16
    xs, rhs, sz = draw(m, 16, 32, 4, sum(sizes), sizes=sizes)
    (txs, trhs, tsz), (jxs, jrhs, jsz) = both(xs, rhs, sz, "float32")
    got = tgmm.gmm_plain(txs, trhs, tsz, block_m=bm)
    assert_forward_close(got, jax.lax.ragged_dot(jxs, jrhs, jsz), "float32")
    assert_forward_close(got, gmm_reference(jxs, jrhs, jsz), "float32")
    assert bool((got[sum(sizes):] == 0).all())


def _grad_pair(m, k, n, g, seed, dtype, sizes=None):
    xs, rhs, sz = draw(m, k, n, g, seed, sizes=sizes)
    (txs, trhs, tsz), (jxs, jrhs, jsz) = both(xs, rhs, sz, dtype)
    cot = np.random.default_rng(seed + 1).normal(size=(m, n)).astype(np.float32)
    tcot = torch.from_numpy(cot).to(txs.dtype)
    jcot = jnp.asarray(cot).astype(dtype)

    def tloss(x, w):
        return torch.sum(ops.grouped_matmul(x, w, tsz, block_m=16).to(torch.float32)
                         * tcot.to(torch.float32))

    def jloss(x, w):
        return jnp.sum(jax.lax.ragged_dot(x, w, jsz).astype(jnp.float32)
                       * jcot.astype(jnp.float32))

    got = torch.func.grad(tloss, argnums=(0, 1))(txs, trhs)
    want = jax.grad(jloss, argnums=(0, 1))(jxs, jrhs)
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", [None, [0, 30, 0, 20]], ids=["multinomial", "empty-and-past"])
def test_gradients_match_jax_grad_of_ragged_dot(dtype, sizes):
    got, want = _grad_pair(64, 32, 48, 4, 5, dtype, sizes=sizes)
    for name, g, w in zip(("dx", "drhs"), got, want):
        g, w = np32(g), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        if dtype == "float32":
            assert np.abs(g - w).max() <= 1e-5 * scale, (name, np.abs(g - w).max())
        else:
            assert np.all(np.abs(g - w) <= bf16_ulp(np.abs(w)) + 1e-2 * scale), name
    if sizes is not None:   # rows past the last group get no gradient
        assert bool((got[0][50:] == 0).all())


def test_rhs_grad_is_per_group_product():
    xs, rhs, sz = draw(40, 8, 12, 3, 9, sizes=[10, 0, 25])
    dy = np.random.default_rng(3).normal(size=(40, 12)).astype(np.float32)
    got = tgmm.gmm_rhs_grad(torch.from_numpy(xs), torch.from_numpy(dy), torch.from_numpy(sz))
    want = np.stack([xs[:10].T @ dy[:10], np.zeros((8, 12)), xs[10:35].T @ dy[10:35]])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shared", [False, True], ids=["per-client-rhs", "shared-rhs"])
def test_vmap_folds_cohort_into_one_call(shared, monkeypatch):
    """vmap ∘ grad over a cohort: one forward call per product (the cohort
    folded into C·G groups) and one for dX in the backward, equal bitwise to
    the per-client loop; rhs shared by the clients (the first local step's
    broadcast params) as well as per client."""
    c, m, k, n, g = 3, 24, 16, 8, 4
    rng = np.random.default_rng(11)
    xs = torch.from_numpy(rng.normal(size=(c, m, k)).astype(np.float32))
    rhs = torch.from_numpy(rng.normal(size=(c, g, k, n)).astype(np.float32))
    sizes = torch.tensor([[6, 6, 6, 6], [0, 10, 3, 2], [7, 0, 0, 9]], dtype=torch.int32)
    if shared:
        rhs = rhs[0]

    def loss(w, x, s):
        return torch.sum(ops.grouped_matmul(x, w, s, block_m=8) ** 2)

    calls = []
    real = tgmm.grouped_matmul_fwd

    def counted(xs_, rhs_, sizes_, **kw):
        calls.append((tuple(xs_.shape), tuple(sizes_.shape)))
        return real(xs_, rhs_, sizes_, **kw)

    monkeypatch.setattr(tgmm, "grouped_matmul_fwd", counted)
    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                            in_dims=(None if shared else 0, 0, 0))(rhs, xs, sizes)
    assert calls == [((c * m, k), (c, g)), ((c * m, n), (c, g))]
    for i in range(c):
        w = (rhs if shared else rhs[i]).clone().requires_grad_()
        x = xs[i].clone().requires_grad_()
        loss(w, x, sizes[i]).backward()
        np.testing.assert_array_equal(grads[0][i].numpy(), w.grad.numpy())
        np.testing.assert_array_equal(grads[1][i].numpy(), x.grad.numpy())


def test_folded_plain_call_equals_client_loop():
    """grouped_matmul_fwd over C clients (CPU: the plain version per client)."""
    c, m, k, n, g = 2, 20, 8, 6, 3
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.normal(size=(c * m, k)).astype(np.float32))
    rhs = torch.from_numpy(rng.normal(size=(c, g, k, n)).astype(np.float32))
    sizes = torch.tensor([[5, 0, 15], [20, 0, 0]], dtype=torch.int32)
    out = tgmm.grouped_matmul_fwd(xs, rhs, sizes, block_m=8)
    for i in range(c):
        np.testing.assert_array_equal(
            out[i * m:(i + 1) * m].numpy(),
            tgmm.gmm_plain(xs[i * m:(i + 1) * m], rhs[i], sizes[i], block_m=8).numpy())
    assert tgmm.LAUNCHES["grouped_matmul"] == 0


def test_refuses_what_the_kernel_does_not_take():
    xs = torch.zeros(8, 4)
    rhs = torch.zeros(2, 4, 3)
    sizes = torch.tensor([4, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        tgmm.grouped_matmul_fwd(xs, rhs.to(torch.bfloat16), sizes)
    with pytest.raises(ValueError, match="int32"):
        tgmm.grouped_matmul_fwd(xs, rhs, sizes.to(torch.int64))
    with pytest.raises(ValueError, match="disagree"):
        tgmm.grouped_matmul_fwd(xs, torch.zeros(3, 4, 3), sizes)
    with pytest.raises(ValueError, match="block_m"):
        tgmm.grouped_matmul_fwd(xs, rhs, sizes, block_m=256)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgmm.gmm_cuda(xs, rhs, sizes)
