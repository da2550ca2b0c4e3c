"""K7 (the SSD chunk) and ``ops.ssd_forward`` of the port against the
reference, on the CPU.

The plain version of K7 (``ssd_chunk_plain``, what a CPU tensor takes) is
held against the reference's Pallas kernel in interpret mode
(``kernels.ssd_scan.ssd_chunk``); the port's ``ops.ssd_forward`` against the
reference's ``ops.ssd_forward(interpret=True)``, its model's jnp
``mamba2._ssd_chunked`` and the exact recurrence ``ref.ssd_reference``.
Inputs are drawn with numpy from a seed, at the model's scales: dt a softplus
of N(−2, 0.5) (≈ 0.13, as at init), A = −exp(N(0, 0.3)).

Tolerance: rtol 1e-5 and atol 1e-5 of the output's largest entry, in f32.
The port sums cum in f64 and rounds once (``chunk_cumsum``); the reference
sums it in f32. At these shapes the log decay reaches a few units, so the two
cums differ by a few f32 ulps of that, which moves each decay weight by
~1e-6 relative; the products reassociate on top of that (measured gaps
≤ 3.4e-7 of the largest entry).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jssd
from repro.models import mamba2 as jmamba
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd
from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files on parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def draw_chunks(bsz, nc, cl, nh, hp, n, seed=0):
    """K7's operands in the chunked layout, a_neg per batch row."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    dt = np.log1p(np.exp(-2.0 + 0.5 * f(bsz, nc, cl, nh))).astype(np.float32)
    a = (-np.exp(0.3 * f(nh))).astype(np.float32)
    return f(bsz, nc, cl, nh, hp), dt, a, f(bsz, nc, cl, n), f(bsz, nc, cl, n)


def draw_seq(bsz, s, nh, hp, n, seed=0, dt_value=None):
    """``ssd_forward``'s operands: x (B,S,NH,HP), dt (B,S,NH), a (NH,),
    b, c (B,S,N); dt is constant if ``dt_value`` is given."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    dt = np.log1p(np.exp(-2.0 + 0.5 * f(bsz, s, nh))).astype(np.float32)
    if dt_value is not None:
        dt = np.full_like(dt, dt_value)
    a = (-np.exp(0.3 * f(nh))).astype(np.float32)
    return f(bsz, s, nh, hp), dt, a, f(bsz, s, n), f(bsz, s, n)


def t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def close(got, want, name="", rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()),
                               err_msg=name)


# (B, NC, CL, NH, HP, N)
CHUNK_CASES = [(2, 3, 16, 3, 8, 16), (1, 2, 32, 4, 32, 16), (3, 1, 32, 2, 8, 8),
               (2, 2, 20, 2, 16, 16)]
CHUNK_IDS = ["cl16-hp8", "cl32-hp32", "cl32-b3", "cl20-ragged"]


@pytest.mark.parametrize("case", CHUNK_CASES, ids=CHUNK_IDS)
def test_plain_chunk_matches_pallas_kernel(case):
    bsz, nc, cl, nh, hp, n = case
    x, dt, a, b, c = draw_chunks(*case)
    y, states, cum_last = tssd.ssd_chunk_plain(*t((x, dt, np.tile(a, (bsz, 1)), b, c)))
    assert y.shape == (bsz, nc, cl, nh, hp) and states.shape == (bsz, nc, nh, hp, n)
    assert cum_last.shape == (bsz, nc, nh)
    jy, jstates, jcum = jssd.ssd_chunk(*map(jnp.asarray, (x, dt, a, b, c)), interpret=True)
    close(y, jy)
    close(states, jstates)
    close(cum_last, jcum)
    assert tssd.LAUNCHES["ssd_chunk"] == 0  # the plain version does not count


# (B, S, NH, HP, N, chunk)
SEQ_CASES = [(2, 64, 3, 8, 16, 16), (1, 70, 2, 16, 16, 32), (2, 32, 4, 32, 16, 32),
             (1, 45, 2, 8, 8, 16)]
SEQ_IDS = ["4-chunks", "ragged-70-by-32", "one-chunk", "ragged-45-by-16"]


@pytest.mark.parametrize("case", SEQ_CASES, ids=SEQ_IDS)
def test_ssd_forward_matches_reference(case):
    bsz, s, nh, hp, n, chunk = case
    x, dt, a, b, c = draw_seq(bsz, s, nh, hp, n, seed=1)
    y, h = tops.ssd_forward(*t((x, dt, a, b, c)), chunk=chunk)
    assert y.shape == (bsz, s, nh, hp) and h.shape == (bsz, nh, hp, n)
    j = list(map(jnp.asarray, (x, dt, a, b, c)))
    refs = {"ops.ssd_forward": jops.ssd_forward(*j, chunk=chunk, interpret=True),
            "_ssd_chunked": jmamba._ssd_chunked(*j, chunk),
            "ssd_reference": jref.ssd_reference(*j)}
    for name, (jy, jh) in refs.items():
        close(y, jy, name)
        close(h, jh, name)
    # The port's own oracle is the reference's recurrence.
    ry, rh = tssd.ssd_recurrence(*t((x, dt, a, b, c)))
    close(ry, refs["ssd_reference"][0], "ssd_recurrence")
    close(rh, refs["ssd_reference"][1], "ssd_recurrence")


def test_h0_matches_reference_chunked():
    """A given initial state enters the first chunk, as in ``_ssd_chunked``
    (also with one chunk, where the port otherwise skips the correction)."""
    for s, chunk in ((48, 16), (16, 16)):
        x, dt, a, b, c = draw_seq(2, s, 3, 8, 16, seed=2)
        h0 = np.random.default_rng(3).normal(size=(2, 3, 8, 16)).astype(np.float32)
        y, h = tops.ssd_forward(*t((x, dt, a, b, c)), chunk=chunk, h0=torch.from_numpy(h0))
        jy, jh = jmamba._ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), chunk,
                                      h0=jnp.asarray(h0))
        ry, rh = jref.ssd_reference(*map(jnp.asarray, (x, dt, a, b, c)), h0=jnp.asarray(h0))
        for want_y, want_h in ((jy, jh), (ry, rh)):
            close(y, want_y)
            close(h, want_h)


def test_padding_rows_add_nothing():
    """S not a multiple of the chunk: the padded rows have dt = 0, so the
    last chunk's cum_last equals its last real row's cum and the final state
    equals the one of the unpadded recurrence."""
    x, dt, a, b, c = draw_seq(1, 40, 2, 8, 8, seed=4)
    xt, dtt, at, bt, ct = t((x, dt, a, b, c))
    pad = lambda u, k: torch.nn.functional.pad(u, (0, 0) * k + (0, 8))
    xc = pad(xt, 2).reshape(1, 3, 16, 2, 8)
    dtc = pad(dtt, 1).reshape(1, 3, 16, 2)
    _, _, cum_last = tssd.ssd_chunk_plain(xc, dtc, at.expand(1, 2), pad(bt, 1).reshape(1, 3, 16, 8),
                                          pad(ct, 1).reshape(1, 3, 16, 8))
    cum = tssd.chunk_cumsum(dtt[:, 32:] * at)
    assert torch.equal(cum_last[:, 2], cum[:, -1])
    _, h = tops.ssd_forward(xt, dtt, at, bt, ct, chunk=16)
    close(h, jref.ssd_reference(*map(jnp.asarray, (x, dt, a, b, c)))[1])


@pytest.mark.parametrize("case", [(2, 48, 3, 8, 16, 16), (1, 40, 2, 8, 8, 16)],
                         ids=["3-chunks", "ragged"])
def test_gradient_matches_jax_grad_of_ssd_chunked(case):
    """The port's gradients of a scalar of ``ssd_forward`` (K7's plain
    backward plus autograd through the recurrence) against ``jax.grad`` of
    the reference model's ``_ssd_chunked``, for x, dt, a_neg, b and c."""
    bsz, s, nh, hp, n, chunk = case
    x, dt, a, b, c = draw_seq(bsz, s, nh, hp, n, seed=5)
    rng = np.random.default_rng(6)
    wy = rng.normal(size=(bsz, s, nh, hp)).astype(np.float32)
    wh = rng.normal(size=(bsz, nh, hp, n)).astype(np.float32)

    def jloss(x, dt, a, b, c):
        y, h = jmamba._ssd_chunked(x, dt, a, b, c, chunk)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, dt, a, b, c)))
    leaves = [u.requires_grad_() for u in t((x, dt, a, b, c))]
    y, h = tops.ssd_forward(*leaves, chunk=chunk)
    ((y * torch.from_numpy(wy)).sum() + (h * torch.from_numpy(wh)).sum()).backward()
    for name, u, g in zip(("x", "dt", "a_neg", "b", "c"), leaves, want):
        assert u.grad.shape == u.shape, name
        np.testing.assert_allclose(u.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(g).max()), err_msg=name)


def _vmap_inputs(n_clients=3):
    rng = np.random.default_rng(7)
    x, dt, _, b, c = draw_seq(n_clients * 2, 40, 2, 8, 8, seed=8)
    shape = lambda u: torch.from_numpy(u.reshape(n_clients, 2, *u.shape[1:]))
    a = torch.from_numpy((-np.exp(0.3 * rng.normal(size=(n_clients, 2)))).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(n_clients, 2, 40, 2, 8)).astype(np.float32))
    return shape(x), shape(dt), a, shape(b), shape(c), w


def _client_loss(x, dt, a, b, c, w):
    y, h = tops.ssd_forward(x, dt, a, b, c, chunk=16)
    return (y * w).sum() + h.sum()


@pytest.mark.parametrize("a_batched", [True, False], ids=["a-per-client", "a-shared"])
def test_vmap_of_grad_equals_loop_over_clients(a_batched):
    """``torch.func.vmap`` over 3 clients of ``torch.func.grad``, as
    ``fed.batched`` composes them, with a per-client a_neg (each client
    trains its own ``A_log``) or one shared a_neg (``in_dims=None``, as at a
    cohort's first step), equals one call per client."""
    x, dt, a, b, c, w = _vmap_inputs()
    if not a_batched:
        a = a[0]
    grad = torch.func.grad(_client_loss, argnums=(0, 1, 2, 3, 4))
    grads = torch.func.vmap(grad, in_dims=(0, 0, 0 if a_batched else None, 0, 0, 0))(
        x, dt, a, b, c, w)
    for i in range(3):
        one = grad(x[i], dt[i], a[i] if a_batched else a, b[i], c[i], w[i])
        for name, got, want in zip(("x", "dt", "a_neg", "b", "c"), grads, one):
            torch.testing.assert_close(got[i], want, rtol=1e-6, atol=1e-6, msg=name)


def test_vmap_folds_the_client_axis_into_one_call(monkeypatch):
    """The vmap rule calls the forward once on the folded (n·B, ...) batch,
    with a_neg one row per folded batch row."""
    calls = []
    plain = tssd.ssd_chunk_plain

    def counting(x, dt, a, b, c):
        calls.append((tuple(x.shape), tuple(a.shape)))
        return plain(x, dt, a, b, c)

    monkeypatch.setattr(tssd, "ssd_chunk_plain", counting)
    x, dt, a, b, c, w = _vmap_inputs()
    out = torch.func.vmap(_client_loss)(x, dt, a, b, c, w)
    assert calls == [((6, 3, 16, 2, 8), (6, 2))]
    assert out.shape == (3,)


def test_wrapper_refuses_bad_operands():
    x, dt, a, b, c = t(draw_chunks(2, 1, 16, 2, 8, 8))
    a = a.expand(2, 2)
    with pytest.raises(ValueError, match="float32"):
        tssd.ssd_chunk(x.double(), dt, a, b, c)
    with pytest.raises(ValueError, match="want x"):
        tssd.ssd_chunk(x[0], dt, a, b, c)
    with pytest.raises(ValueError, match="disagree"):
        tssd.ssd_chunk(x, dt[:, :, :8], a, b, c)
    big = t(draw_chunks(1, 1, 257, 1, 8, 8))
    with pytest.raises(ValueError, match="chunk length 257"):
        tssd.ssd_chunk(*big[:2], big[2].expand(1, 1), *big[3:])
    with pytest.raises(ValueError, match="head dim 129"):
        tssd.ssd_chunk(torch.zeros(2, 1, 16, 2, 129), dt, a, b, c)
    with pytest.raises(ValueError, match="state size 257"):
        tssd.ssd_chunk(x, dt, a, torch.zeros(2, 1, 16, 257), torch.zeros(2, 1, 16, 257))
    with pytest.raises(ValueError, match="one device"):
        tssd.ssd_chunk(x, dt, a.to("meta"), b, c)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tssd.ssd_chunk_cuda(x, dt, a, b, c)


def test_large_decay_spread_stays_finite():
    """dt = 2, A = −1, one 64-row chunk: the log decay spreads over 128, so
    the reference model's ``_ssd_chunked`` takes exp of +128 above the
    diagonal, gets inf, and inf·0 = NaN. The port masks before the
    exponential: it is finite and equals the exact recurrence, as the
    Pallas kernel in interpret mode is."""
    x, dt, _, b, c = draw_seq(1, 64, 1, 8, 8, seed=9, dt_value=2.0)
    a = np.array([-1.0], np.float32)
    j = list(map(jnp.asarray, (x, dt, a, b, c)))
    assert not bool(jnp.isfinite(jmamba._ssd_chunked(*j, 64)[0]).all())
    want_y, want_h = jref.ssd_reference(*j)
    y, h = tops.ssd_forward(*t((x, dt, a, b, c)), chunk=64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    close(y, want_y)
    close(h, want_h)
    close(y, jops.ssd_forward(*j, chunk=64, interpret=True)[0])
    leaves = [u.requires_grad_() for u in t((x, dt, a, b, c))]
    tops.ssd_forward(*leaves, chunk=64)[0].sum().backward()
    assert all(bool(torch.isfinite(u.grad).all()) for u in leaves)
