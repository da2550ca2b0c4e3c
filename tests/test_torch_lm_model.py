"""The dense decoder (qwen2 family) of the port against the reference at
``smoke_variant(qwen2-0.5b)``: 2 layers, d_model 256, 4 heads / 2 KV heads,
head_dim 64, d_ff 512, vocab 512, QKV bias, tied embeddings.

Weights are the reference's ``init_params`` output carried with
``repro_torch.convert``. Inputs are drawn with numpy from a seed.

Tolerances:
  * Layers in f32: 1e-6 relative, or 2e-6 absolute for RoPE (XLA's and
    torch's f32 cos/sin/pow differ in the last bit). Layers in bf16:
    within one bf16 ulp (each package rounds the same f32 value once).
  * The whole model with every dtype f32 (both packages' DEFAULT_DTYPE
    patched to float32, where the algorithm is the point): logits atol
    1e-5 (measured 8e-7), loss rtol 1e-6, gradients within 1e-5 of each
    leaf's largest entry (measured ≤ 1e-6).
  * In the default bf16 (activations and matmul weights bf16, norms f32):
    logits within 4 bf16 ulp of the largest logit (measured 1 ulp), loss
    rtol 1e-3 (measured 2e-5), gradients within 3 % of each leaf's largest
    entry (measured ≤ 1.5 %, in the attention biases). Each
    package rounds every bf16 product and sum at its own places, and the
    rounding of one activation moves everything downstream of it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_variant as jax_smoke_variant
from repro.models import build_model as jax_build_model
from repro.models import dense as jdense
from repro.models import layers as jlayers
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import build_model, dense, layers

from test_torch_flash import assert_within_bf16_ulp, bf16_ulp, np32
from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files on parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build_model(jax_smoke_variant(jax_get_config("qwen2-0.5b")))
    tm = build_model(smoke_variant(get_config("qwen2-0.5b")))
    jp = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(1)))
    return jm, tm, jp, params_from_jax(jp)


def batch(cfg, b=2, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return ({"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)},
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})


@pytest.fixture()
def all_f32(monkeypatch):
    """Run both models with f32 activations (the reference's bf16 carry
    cannot hold the f32 residuals that f32 weights produce)."""
    monkeypatch.setattr(jdense, "DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(dense, "DEFAULT_DTYPE", torch.float32)


def test_smoke_variant_is_the_reference_reduction():
    for arch in ("qwen2-0.5b", "resnet18-cifar10"):
        got, want = smoke_variant(get_config(arch)), jax_smoke_variant(jax_get_config(arch))
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), (arch, f.name)
    full = get_config("qwen2-0.5b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size, full.padded_vocab) == \
        (24, 896, 14, 2, 64, 4864, 151936, 152064)


def test_names_shapes_dtypes_match_reference_and_init(pair):
    jm, tm, jp, tp = pair
    named = {n: (tuple(p.shape), p.dtype) for n, p in tm.module.named_parameters()}
    assert named == {n: (tuple(t.shape), t.dtype) for n, t in tp.items()}
    assert named["layers.attn.wq"] == ((2, 256, 4, 64), torch.bfloat16)  # stacked (L, ...)
    assert named["layers.ln1"] == ((2, 256), torch.float32)
    init = tm.init_params(torch.Generator().manual_seed(3))
    assert {n: (tuple(t.shape), t.dtype) for n, t in init.items()} == named
    again = tm.init_params(torch.Generator().manual_seed(3))
    assert all(torch.equal(init[n], again[n]) for n in init)
    assert torch.equal(init["layers.attn.bq"], torch.zeros(2, 4, 64, dtype=torch.bfloat16))
    # Truncated normal at 2σ, σ = 1/√fan_in.
    assert float(init["layers.mlp.w_gate"].float().abs().max()) <= 2.0 / 16 + 1e-3


@pytest.mark.parametrize("family", ["resnet", "dense"])
def test_convert_round_trip_is_bitwise(family, pair):
    if family == "dense":
        jp, tp = pair[2], pair[3]
        # The stacked attention weights keep the reference layout.
        assert tuple(tp["layers.attn.wq"].shape) == jp["layers"]["attn"]["wq"].shape
        assert tuple(tp["layers.attn.wo"].shape) == jp["layers"]["attn"]["wo"].shape
    else:
        jm = jax_build_model(dataclasses.replace(
            jax_smoke_variant(jax_get_config("resnet18-cifar10")), d_model=8))
        jp = jax.tree.map(np.array, jax.jit(jm.init_params)(jax.random.PRNGKey(1)))
        tp = params_from_jax(jp)
        assert tuple(tp["stem"].shape) == (8, 3, 3, 3)   # HWIO → OIHW
    back = params_to_jax(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=str(path))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _draw(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(dtype)


def _j(t):
    a = jnp.asarray(t.to(torch.float32).numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rms_norm_and_rope_match_reference(dtype):
    x = _draw((2, 8, 3, 64), 0, dtype)
    w = 1.0 + 0.1 * _draw((64,), 1)
    got = layers.rms_norm(x, w)
    want = jlayers.rms_norm(_j(x), _j(w))
    assert got.dtype == dtype
    pos = torch.arange(8).expand(2, 8)
    rot = layers.apply_rope(x, pos, 1e6)
    jrot = jlayers.apply_rope(_j(x), jnp.asarray(pos.numpy()), 1e6)
    assert rot.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), rtol=1e-6, atol=2e-6)
    else:
        assert_within_bf16_ulp(got, want)
        assert_within_bf16_ulp(rot, jrot)
    np.testing.assert_allclose(layers.rope_frequencies(64, 1e6).numpy(),
                               np.asarray(jlayers.rope_frequencies(64, 1e6)), rtol=1e-6)


def test_gated_mlp_promotes_mixed_dtypes_as_jax():
    """bf16 activations against f32 weights: jnp.einsum promotes to f32, and
    so does the port (torch.einsum alone would refuse)."""
    x = _draw((2, 5, 32), 0, torch.bfloat16)
    p = {k: _draw(s, i + 1) for i, (k, s) in enumerate(
        (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32))))}
    got = layers.gated_mlp(p, x)
    want = jlayers.gated_mlp({k: _j(v) for k, v in p.items()}, _j(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    pb = {k: v.to(torch.bfloat16) for k, v in p.items()}
    got = layers.gated_mlp(pb, x)
    assert got.dtype == torch.bfloat16
    want = np32(jlayers.gated_mlp({k: _j(v) for k, v in pb.items()}, _j(x)))
    # bf16 end to end: products and the silu round at each op in both.
    tol = 2 * bf16_ulp(np.abs(want).max()) + bf16_ulp(want)
    assert np.all(np.abs(np32(got) - want) <= tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_unembed_masks_padded_vocab_and_cross_entropy(dtype, tie):
    vocab, padded, d = 300, 512, 16
    x = _draw((2, 6, d), 0, dtype)
    p = {"tok_embed": _draw((padded, d), 1, dtype)}
    if not tie:
        p["unembed"] = _draw((d, padded), 2, dtype)
    got = layers.unembed(p, x, vocab)
    want = jlayers.unembed({k: _j(v) for k, v in p.items()}, _j(x), vocab)
    assert got.dtype == dtype
    assert bool((got[..., vocab:] == torch.finfo(dtype).min).all())
    np.testing.assert_array_equal(np32(got)[..., vocab:], np32(want)[..., vocab:])
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    else:
        assert_within_bf16_ulp(got, want)
    labels = torch.from_numpy(np.random.default_rng(3).integers(0, vocab, (2, 6)).astype(np.int32))
    mask = torch.from_numpy((np.arange(12).reshape(2, 6) % 3 != 0).astype(np.float32))
    for m in (None, mask):
        ce = layers.cross_entropy(got, labels, m)
        jce = jlayers.cross_entropy(_j(got), jnp.asarray(labels.numpy()),
                                    None if m is None else jnp.asarray(m.numpy()))
        assert ce.dtype == torch.float32
        np.testing.assert_allclose(float(ce), float(jce), rtol=1e-6)


def test_embed_tokens_matches_reference(pair):
    _, _, jp, tp = pair
    toks = np.random.default_rng(0).integers(0, 512, size=(3, 7)).astype(np.int32)
    got = layers.embed_tokens({"tok_embed": tp["embed.tok_embed"]}, torch.from_numpy(toks))
    want = jlayers.embed_tokens(jp["embed"], jnp.asarray(toks))
    np.testing.assert_array_equal(np32(got), np32(want))


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------


def _grads_close(got, want_tree, frac):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    for name in sorted(got):
        g, w = np32(got[name]), np32(want[name])
        assert got[name].dtype == want[name].dtype, name
        gap, scale = np.abs(g - w).max(), np.abs(w).max()
        assert gap <= frac * scale, (name, float(gap), float(scale))


def test_forward_loss_and_grads_match_reference_in_f32(pair, all_f32):
    jm, tm, jp, tp = pair
    jp32 = jax.tree.map(lambda a: a.astype(np.float32), jp)
    tp32 = {k: v.to(torch.float32) for k, v in tp.items()}
    tb, jb = batch(tm.cfg)
    logits = tm.forward(tp32, tb)
    want = np.asarray(jm.forward(jp32, jb))
    assert logits.dtype == torch.float32 and logits.shape == (2, 32, 512)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-5)
    loss, grads = torch.func.grad_and_value(tm.loss)(tp32, tb)[::-1]
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp32, jb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    _grads_close(grads, jgrads, 1e-5)
    assert tfa.LAUNCHES["flash_attention"] == 0


def test_forward_loss_and_grads_match_reference_in_bf16(pair):
    jm, tm, jp, tp = pair
    tb, jb = batch(tm.cfg, seed=1)
    logits = tm.forward(tp, tb)
    want = np32(jm.forward(jp, jb))
    assert logits.dtype == torch.bfloat16
    got = np32(logits)
    assert np.abs(got - want).max() <= 4 * bf16_ulp(np.abs(want).max())
    loss, grads = torch.func.grad_and_value(tm.loss)(tp, tb)[::-1]
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    _grads_close(grads, jgrads, 0.03)


def test_padded_vocab_logits_hold_the_dtype_min():
    cfg = dataclasses.replace(smoke_variant(get_config("qwen2-0.5b")), vocab_size=300,
                              num_layers=1)
    tm = build_model(cfg)
    assert cfg.padded_vocab == 512
    params = tm.init_params(torch.Generator().manual_seed(0))
    logits = tm.forward(params, {"tokens": torch.zeros(1, 4, dtype=torch.int32)})
    assert logits.shape == (1, 4, 512)
    assert bool((logits[..., 300:] == torch.finfo(torch.bfloat16).min).all())
    assert bool(torch.isfinite(logits[..., :300]).all())
