"""The Llama-3.2-Vision-style decoder (vlm family) of the port against the
reference.

Model: ``smoke_variant(llama-3.2-vision-90b)`` with ``vision_tokens=37``: 2
layers (one super-block of a self layer and a gated cross-attention layer),
d_model 256, 4 query and 2 KV heads of 64, d_ff 512, vocab 512. 37 vision
keys leave a ragged last tile of 5 in the plain version's 32-key blocking.
Both tanh gates of the cross layer are set to 0.5 (at their zero init the
cross layer adds exactly nothing, so a wrong cross-attention would pass
unseen). Weights are the reference's ``init_params`` output carried with
``repro_torch.convert``; tokens and vision embeddings are drawn with numpy
from a seed. The full width is checked by names, shapes and dtypes only
(``jax.eval_shape``). Cross-attention is K5 non-causal with S ≠ T (its
plain version here).

Tolerances (those of ``test_torch_lm_model.py``):
  * every dtype f32 (``DEFAULT_DTYPE`` patched to float32 in both packages'
    vlm modules): logits atol 1e-5, loss rtol 1e-6, every leaf's gradient
    within 1e-5 of its largest entry;
  * in the default bf16: logits within 4 bf16 ulp of the largest logit,
    loss rtol 1e-3, gradients within 3 % of each leaf's largest entry.
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
from repro.models import vlm as jvlm
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import build_model, vlm

from test_torch_flash import bf16_ulp, np32

ARCH = "llama-3.2-vision-90b"
VISION = 37


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files on parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build_model(dataclasses.replace(jax_smoke_variant(jax_get_config(ARCH)),
                                             vision_tokens=VISION))
    tm = build_model(dataclasses.replace(smoke_variant(get_config(ARCH)),
                                         vision_tokens=VISION))
    jp = jax.tree.map(np.array, jax.jit(jm.init_params)(jax.random.PRNGKey(1)))
    zero = params_from_jax(jp)
    for gate in ("gate_attn", "gate_mlp"):
        jp["cross_layers"][gate] = np.full_like(jp["cross_layers"][gate], 0.5)
    return jm, tm, jp, params_from_jax(jp), zero


def batch(cfg, b=2, s=40, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    vis = torch.from_numpy(rng.normal(size=(b, cfg.vision_tokens, cfg.d_model))
                           .astype(np.float32)).to(torch.bfloat16)
    return ({"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks),
             "vision_embeds": vis},
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
             "vision_embeds": jnp.asarray(vis.float().numpy()).astype(jnp.bfloat16)})


def test_config_smoke_variant_and_layer_plan_are_the_reference():
    full, want = get_config(ARCH), jax_get_config(ARCH)
    smoke, want_smoke = smoke_variant(full), jax_smoke_variant(want)
    for f in dataclasses.fields(full):
        assert getattr(full, f.name) == getattr(want, f.name), f.name
        assert getattr(smoke, f.name) == getattr(want_smoke, f.name), f.name
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.d_ff, full.padded_vocab, full.vision_tokens) == \
        (100, 8192, 64, 8, 128, 28672, 128256, 1601)
    assert (smoke.cross_attn_every, smoke.vision_tokens) == (2, 16)
    for layers in (2, 4, 5, 100):
        c = dataclasses.replace(full if layers % 5 == 0 else smoke, num_layers=layers)
        assert vlm.layer_plan(c) == jvlm.layer_plan(c)
    with pytest.raises(AssertionError, match="super-blocks"):
        vlm.layer_plan(dataclasses.replace(smoke, num_layers=3))


def test_full_width_names_shapes_dtypes_match_reference():
    """At every width, 5 layers (one super-block, chip_smoke.py's cut of the
    depth), without arrays."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=5)
    jcfg = dataclasses.replace(jax_get_config(ARCH), num_layers=5)
    shapes = jax.eval_shape(lambda k: jvlm.init_params(k, jcfg), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(path, simple=True, separator="."): (tuple(a.shape),
                                                                       str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in build_model(cfg).module.named_parameters()}
    assert got == want
    assert sum(int(np.prod(s)) for s, _ in got.values()) == 6_379_626_498


def test_names_shapes_dtypes_match_reference_init_and_round_trip(pair):
    jm, tm, jp, tp, _ = pair
    named = {n: (tuple(p.shape), p.dtype) for n, p in tm.module.named_parameters()}
    assert named == {n: (tuple(t.shape), t.dtype) for n, t in tp.items()}
    assert named["self_layers.attn.wq"] == ((1, 1, 256, 4, 64), torch.bfloat16)
    assert named["cross_layers.gate_attn"] == ((1,), torch.float32)
    init = tm.init_params(torch.Generator().manual_seed(3))
    assert {n: (tuple(t.shape), t.dtype) for n, t in init.items()} == named
    assert not bool(init["cross_layers.gate_attn"].any() | init["cross_layers.gate_mlp"].any())
    again = tm.init_params(torch.Generator().manual_seed(3))
    assert all(torch.equal(init[n], again[n]) for n in init)
    back = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(tp)))
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        np.testing.assert_array_equal(a.view(np.uint8), back[path].view(np.uint8))


def test_zero_gates_add_nothing_and_half_gates_read_the_vision(pair):
    _, tm, _, tp, zero = pair
    tb, _ = batch(tm.cfg)
    other = dict(tb, vision_embeds=-tb["vision_embeds"])
    assert torch.equal(tm.forward(zero, tb), tm.forward(zero, other))
    assert not torch.equal(tm.forward(tp, tb), tm.forward(tp, other))


def reference_values(jm, jp, jb):
    """The reference's logits, loss and gradients in one compiled call."""
    def f(p, b):
        return jm.forward(p, b), jax.value_and_grad(jm.loss)(p, b)

    logits, (loss, grads) = jax.jit(f)(jp, jb)
    return np32(logits), float(loss), grads


def _grads_close(got, want_tree, frac):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    for name in sorted(got):
        g, w = np32(got[name]), np32(want[name])
        assert got[name].dtype == want[name].dtype, name
        gap, scale = np.abs(g - w).max(), np.abs(w).max()
        assert gap <= frac * scale, (name, float(gap), float(scale))


def test_forward_loss_and_grads_match_reference_in_f32(pair, monkeypatch):
    monkeypatch.setattr(jvlm, "DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(vlm, "DEFAULT_DTYPE", torch.float32)
    jm, tm, jp, tp, _ = pair
    jp32 = jax.tree.map(lambda a: a.astype(np.float32), jp)
    tp32 = {k: v.to(torch.float32) for k, v in tp.items()}
    tb, jb = batch(tm.cfg)
    logits = tm.forward(tp32, tb)
    want, jloss, jgrads = reference_values(jm, jp32, jb)
    assert logits.dtype == torch.float32 and logits.shape == (2, 40, 512)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-5)
    loss, grads = torch.func.grad_and_value(tm.loss)(tp32, tb)[::-1]
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    _grads_close(grads, jgrads, 1e-5)
    for name in ("cross_layers.gate_attn", "cross_layers.gate_mlp", "cross_layers.attn.wk"):
        assert float(grads[name].abs().max()) > 0, name
    assert tfa.LAUNCHES["flash_attention"] == 0


def test_forward_loss_and_grads_match_reference_in_bf16(pair):
    jm, tm, jp, tp, _ = pair
    tb, jb = batch(tm.cfg, seed=1)
    logits = tm.forward(tp, tb)
    want, jloss, jgrads = reference_values(jm, jp, jb)
    assert logits.dtype == torch.bfloat16
    assert np.abs(np32(logits) - want).max() <= 4 * bf16_ulp(np.abs(want).max())
    loss, grads = torch.func.grad_and_value(tm.loss)(tp, tb)[::-1]
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-3)
    _grads_close(grads, jgrads, 0.03)


def test_cross_attention_is_k5_non_causal_over_the_vision_keys(pair, monkeypatch):
    """The cross layer calls K5 once, non-causal, with q (B,S,H,D) and k, v
    (B,T,KVH,D) at T = vision_tokens and no KV-head repeat; the self layer
    calls it causal with T = S."""
    _, tm, _, tp, _ = pair
    seen = []
    real = tfa.flash_attention_fwd

    def spy(q, k, v, *, causal, window=0):
        seen.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(tfa, "flash_attention_fwd", spy)
    tb, _ = batch(tm.cfg)
    tm.forward(tp, tb)
    assert seen == [((2, 40, 4, 64), (2, 40, 2, 64), True),
                    ((2, 40, 4, 64), (2, VISION, 2, 64), False)]
