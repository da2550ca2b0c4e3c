"""K5 (flash attention) of the port against the reference, on the CPU.

The plain version of K5 (``flash_attention_plain``, what a CPU tensor takes)
is held against the reference's Pallas kernel in interpret mode
(``kernels.flash_attention.flash_attention`` and ``ops.flash_mha``), its jnp
``models.attention.blockwise_attention`` and the materialized oracle
``kernels.ref.mha_reference``. Inputs are drawn with numpy from a seed.

Tolerances:
  * f32 outputs: atol = rtol = 1e-5. The functions agree up to the order of
    f32 sums: the port rescales every 32 keys, the Pallas kernel every
    min(128, T) and ``blockwise_attention`` every min(1024, T) (measured
    gap ≤ 1e-6 on outputs of order 1).
  * bf16 outputs: within one bf16 ulp of the reference's output, plus 1e-6
    absolute. Both round an f32 result to bf16 once; f32 results that differ
    in the last bits can round to neighbouring bf16 values, and where the
    p·v sum cancels to near 0 the f32 results differ by up to ~5e-7 (against
    f64), more than one bf16 ulp of such an output.
  * Gradients against ``jax.grad`` of ``blockwise_attention``: f32 to
    atol = rtol = 1e-5 (measured ≤ 8e-6 on entries up to 12); bf16 to 2 ulp
    of the gradient's largest entry plus one ulp of each entry (measured ≤ 1
    ulp of the largest entry). The port's backward forms rowsum(dO ∘ O) from
    the bf16-rounded output O (the standard flash backward), where JAX
    differentiates through the f32 value before its cast, and each package
    rounds every gradient to bf16 once.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)


F32 = dict(atol=1e-5, rtol=1e-5)

# (B, S, T, H, KVH, D, causal, window)
CASES = [
    (2, 32, 32, 14, 2, 64, True, 0),     # the LM path's shape (GQA 14/2, D 64), cut in batch
    (1, 100, 100, 4, 4, 32, True, 0),    # MHA; T not a multiple of any block
    (2, 70, 70, 4, 2, 16, False, 0),     # non-causal, ragged last tile
    (1, 200, 200, 4, 1, 16, True, 48),   # sliding window: rows whose first tiles are all masked
    (2, 20, 20, 2, 2, 8, True, 0),       # S smaller than every block
    (1, 20, 70, 4, 2, 16, False, 0),     # cross lengths S < T, non-causal
]
IDS = ["gqa-path", "mha-ragged", "noncausal", "window", "short", "cross"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files on parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def draw(b, s, t, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, t, kvh, d)).astype(np.float32),
            rng.normal(size=(b, t, kvh, d)).astype(np.float32))


def to_torch(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def to_jax(tensors):
    """The same values (bf16 exactly) as JAX arrays of the same dtype."""
    out = []
    for t in tensors:
        a = jnp.asarray(t.to(torch.float32).numpy())
        out.append(a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a)
    return out


def np32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.to(torch.float32).numpy()


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 at |x| (8 significant bits), floored at the smallest
    normal's spacing."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def assert_within_bf16_ulp(got, want, atol=1e-6):
    """|got − want| ≤ one bf16 ulp of ``want`` + ``atol`` (the f32 error
    before the cast, which matters only where the value is near 0)."""
    got, want = np32(got), np32(want)
    gap = np.abs(got - want)
    assert np.all(gap <= bf16_ulp(want) + atol), float(gap.max())


def mha_flat(q, k, v):
    """(B,S,H,D)/(B,T,KVH,D) → the Pallas kernel's (B·H, S|T, D), KV heads
    repeated as ``ops.flash_mha`` repeats them."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
    flat = lambda x: x.transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], d)
    return flat(q), flat(k), flat(v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_reference_kernels(case, dtype):
    b, s, t, h, kvh, d, causal, window = case
    q, k, v = to_torch(draw(b, s, t, h, kvh, d), dtype)
    o, lse = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert o.dtype == dtype and o.shape == (b, s, h, d)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    jq, jk, jv = to_jax((q, k, v))

    refs = {
        "blockwise_attention": jattn.blockwise_attention(jq, jk, jv, causal=causal,
                                                         window=window),
        "ops.flash_mha": jops.flash_mha(jq, jk, jv, causal=causal, window=window,
                                        interpret=True),
    }
    fq, fk, fv = mha_flat(jq, jk, jv)
    flat = jfa.flash_attention(fq, fk, fv, causal=causal, window=window, interpret=True)
    refs["flash_attention"] = flat.reshape(b, h, s, d).transpose(0, 2, 1, 3)
    oracle = jref.mha_reference(fq, fk, fv, causal=causal, window=window)
    refs["mha_reference"] = oracle.reshape(b, h, s, d).transpose(0, 2, 1, 3)
    for name, want in refs.items():
        assert want.dtype == (jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        if dtype == torch.float32:
            np.testing.assert_allclose(o.numpy(), np.asarray(want), err_msg=name, **F32)
        else:
            assert_within_bf16_ulp(o, want)

    # lse is the log of the softmax denominator: exp(s - lse) sums to 1.
    qf, kf = q.to(torch.float32), k.to(torch.float32).repeat_interleave(h // kvh, 2)
    sc = torch.einsum("bshd,bthd->bhst", qf / math.sqrt(d), kf)
    qp, kp = torch.arange(s)[:, None], torch.arange(t)[None, :]
    mask = torch.ones(s, t, dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    p = torch.where(mask, torch.exp(sc - lse[..., None]), 0.0)
    torch.testing.assert_close(p.sum(-1), torch.ones_like(lse), atol=1e-5, rtol=0)
    assert tfa.LAUNCHES["flash_attention"] == 0  # the plain version does not count


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[3]], ids=["gqa", "mha", "window"])
def test_gradient_matches_jax_grad_of_blockwise_attention(case, dtype):
    b, s, t, h, kvh, d, causal, window = case
    q, k, v = to_torch(draw(b, s, t, h, kvh, d, seed=1), dtype)
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(b, s, h, d)).astype(np.float32))

    def jloss(q, k, v):
        o = jattn.blockwise_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w.numpy()))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*to_jax((q, k, v)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = tops.flash_mha(*leaves, causal=causal, window=window)
    (o.to(torch.float32) * w).sum().backward()
    for name, x, g in zip("qkv", leaves, want):
        assert x.grad.dtype == dtype, name
        if dtype == torch.float32:
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), err_msg=name, **F32)
        else:
            got, ref = np32(x.grad), np32(g)
            tol = 2 * bf16_ulp(np.abs(ref).max()) + bf16_ulp(ref)
            assert np.all(np.abs(got - ref) <= tol), (name, float(np.abs(got - ref).max()))


def test_wrapper_refuses_bad_operands():
    q = torch.randn(1, 8, 4, 16)
    k = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        tfa.flash_attention_fwd(q, k.to(torch.bfloat16), k, causal=True)
    with pytest.raises(ValueError, match="disagree"):
        tfa.flash_attention_fwd(q, torch.randn(1, 8, 3, 16), torch.randn(1, 8, 3, 16),
                                causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.randn(1, 8, 1, 300)
        tfa.flash_attention_fwd(big, big, big, causal=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_cuda(q, k, k, causal=True)
