"""The HuBERT-style encoder (encoder family) of the port against the
reference.

Model: ``smoke_variant(hubert-xlarge)``: 2 layers, d_model 256, 4 MHA heads
of 64, d_ff 512, vocab 504 padded to 512 (8 head columns masked to the
dtype's min). Weights are the reference's ``init_params`` output carried
with ``repro_torch.convert``; frames, the mask (about 40 % of the positions,
never all or none of a row) and the cluster labels are drawn with numpy
from a seed. The full width is checked by names, shapes and dtypes only
(``jax.eval_shape``). Attention is K5 non-causal (its plain version here).

Tolerances (those of ``test_torch_lm_model.py``):
  * every dtype f32 (``DEFAULT_DTYPE`` patched to float32 in both packages'
    encoder modules): logits atol 1e-5, loss rtol 1e-6, every leaf's
    gradient within 1e-5 of its largest entry;
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
from repro.models import encoder as jencoder
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.fed.client import local_train
from repro_torch.models import build_model, encoder

from test_torch_flash import bf16_ulp, np32
from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)

ARCH = "hubert-xlarge"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files on parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build_model(jax_smoke_variant(jax_get_config(ARCH)))
    tm = build_model(smoke_variant(get_config(ARCH)))
    jp = jax.tree.map(np.array, jax.jit(jm.init_params)(jax.random.PRNGKey(1)))
    return jm, tm, jp, params_from_jax(jp)


def reference_values(jm, jp, jb):
    """The reference's logits (the model's forward, which takes no mask),
    masked logits, loss and gradients, in one compiled call."""
    def f(p, b):
        masked = jencoder.forward(jm.cfg, p, b["frames"], b["mask"], remat=False)
        return jm.forward(p, b), masked, jax.value_and_grad(jm.loss)(p, b)

    logits, masked, (loss, grads) = jax.jit(f)(jp, jb)
    return np32(logits), np32(masked), float(loss), grads


def batch(cfg, b=2, s=40, seed=0):
    """Frames, a mask over some positions of every row, cluster labels."""
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    mask = rng.uniform(size=(b, s)) < 0.4
    mask[:, 0], mask[:, 1] = True, False
    labels = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    fb = torch.from_numpy(frames).to(torch.bfloat16)
    tb = {"frames": fb, "mask": torch.from_numpy(mask), "labels": torch.from_numpy(labels)}
    jb = {"frames": jnp.asarray(fb.float().numpy()).astype(jnp.bfloat16),
          "mask": jnp.asarray(mask), "labels": jnp.asarray(labels)}
    return tb, jb


def test_config_and_smoke_variant_are_the_reference():
    full, want = get_config(ARCH), jax_get_config(ARCH)
    smoke, want_smoke = smoke_variant(full), jax_smoke_variant(want)
    for f in dataclasses.fields(full):
        assert getattr(full, f.name) == getattr(want, f.name), f.name
        assert getattr(smoke, f.name) == getattr(want_smoke, f.name), f.name
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size, full.padded_vocab,
            full.is_encoder) == (48, 1280, 16, 16, 80, 5120, 504, 512, True)
    assert (smoke.num_layers, smoke.d_model, smoke.num_heads, smoke.num_kv_heads,
            smoke.vocab_size) == (2, 256, 4, 4, 504)


def test_full_width_names_shapes_dtypes_match_reference():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    shapes = jax.eval_shape(lambda k: jencoder.init_params(k, jcfg), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(path, simple=True, separator="."): (tuple(a.shape),
                                                                       str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in build_model(cfg).module.named_parameters()}
    assert got == want
    n_params = sum(int(np.prod(s)) for s, _ in got.values())
    n_bytes = sum(int(np.prod(s)) * (2 if d == "bfloat16" else 4) for s, d in got.values())
    assert (n_params, n_bytes) == (1_259_072_000, 2_518_394_880)


def test_names_shapes_dtypes_match_reference_init_and_round_trip(pair):
    _, tm, jp, tp = pair
    named = {n: (tuple(p.shape), p.dtype) for n, p in tm.module.named_parameters()}
    assert named == {n: (tuple(t.shape), t.dtype) for n, t in tp.items()}
    assert named["head"] == ((256, 512), torch.bfloat16)
    init = tm.init_params(torch.Generator().manual_seed(3))
    assert {n: (tuple(t.shape), t.dtype) for n, t in init.items()} == named
    again = tm.init_params(torch.Generator().manual_seed(3))
    assert all(torch.equal(init[n], again[n]) for n in init)
    assert 0.005 < float(init["mask_embed"].std()) < 0.05
    back = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(tp)))
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        np.testing.assert_array_equal(a.view(np.uint8), back[path].view(np.uint8))


def _grads_close(got, want_tree, frac):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    for name in sorted(got):
        g, w = np32(got[name]), np32(want[name])
        assert got[name].dtype == want[name].dtype, name
        gap, scale = np.abs(g - w).max(), np.abs(w).max()
        assert gap <= frac * scale, (name, float(gap), float(scale))


def test_forward_loss_and_grads_match_reference_in_f32(pair, monkeypatch):
    monkeypatch.setattr(jencoder, "DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(encoder, "DEFAULT_DTYPE", torch.float32)
    jm, tm, jp, tp = pair
    jp32 = jax.tree.map(lambda a: a.astype(np.float32), jp)
    tp32 = {k: v.to(torch.float32) for k, v in tp.items()}
    tb, jb = batch(tm.cfg)
    want_logits, want_masked, jloss, jgrads = reference_values(jm, jp32, jb)
    # The model's forward (no mask, as the reference's) and the masked one.
    logits = tm.forward(tp32, tb)
    assert logits.dtype == torch.float32 and logits.shape == (2, 40, 512)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0, atol=1e-5)
    masked = encoder.forward(tm.cfg, tp32, tb["frames"], tb["mask"])
    np.testing.assert_allclose(masked.numpy(), want_masked, rtol=0, atol=1e-5)
    assert not np.allclose(masked.numpy(), logits.numpy())
    assert bool((masked[..., 504:] == torch.finfo(torch.float32).min).all())
    loss, grads = torch.func.grad_and_value(tm.loss)(tp32, tb)[::-1]
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    _grads_close(grads, jgrads, 1e-5)
    assert float(grads["mask_embed"].abs().max()) > 0


def test_forward_loss_and_grads_match_reference_in_bf16(pair):
    jm, tm, jp, tp = pair
    tb, jb = batch(tm.cfg, seed=1)
    _, want, jloss, jgrads = reference_values(jm, jp, jb)
    logits = encoder.forward(tm.cfg, tp, tb["frames"], tb["mask"])
    assert logits.dtype == torch.bfloat16
    top = np.abs(want[..., :504]).max()
    assert np.abs(np32(logits)[..., :504] - want[..., :504]).max() <= 4 * bf16_ulp(top)
    loss, grads = torch.func.grad_and_value(tm.loss)(tp, tb)[::-1]
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-3)
    _grads_close(grads, jgrads, 0.03)


def test_masked_loss_counts_only_the_masked_positions(pair):
    """Labels at unmasked positions do not move the loss; with no position
    masked the loss is 0 (the reference's max(Σ mask, 1) denominator)."""
    _, tm, _, tp = pair
    tb, _ = batch(tm.cfg, seed=2)
    loss = tm.loss(tp, tb)
    other = dict(tb, labels=torch.where(tb["mask"], tb["labels"], (tb["labels"] + 1) % 504))
    assert torch.equal(tm.loss(tp, other), loss)
    assert float(tm.loss(tp, dict(tb, mask=torch.zeros_like(tb["mask"])))) == 0.0


def test_one_client_visit_matches_reference_local_steps(pair):
    """``fed.client.local_train`` for two steps (lr 0.05, μ 0.1) against the
    reference's FedProx SGD written out with ``jax.grad``: the mean loss to
    rtol 1e-3 and the trained weights within 3 % of each leaf's largest
    update."""
    jm, tm, jp, tp = pair
    steps = [batch(tm.cfg, s=24, seed=10 + i) for i in range(2)]
    stacked = {k: torch.stack([tb[k] for tb, _ in steps]) for k in steps[0][0]}
    res = local_train(tm.loss, tp, stacked, lr=0.05, mu=0.1)
    w, losses = jp, []
    value_and_grad = jax.jit(jax.value_and_grad(jm.loss))
    for _, jb in steps:
        loss, g = value_and_grad(w, jb)
        losses.append(float(loss))
        w = jax.tree.map(lambda p, gi, a: (p.astype(jnp.float32) - 0.05 * (
            gi.astype(jnp.float32) + 0.1 * (p.astype(jnp.float32) - a.astype(jnp.float32))
            .astype(gi.dtype).astype(jnp.float32))).astype(p.dtype), w, g, jp)
    np.testing.assert_allclose(float(res.mean_loss), np.mean(losses), rtol=1e-3)
    want = params_from_jax(jax.tree.map(np.asarray, w))
    for name, p in res.params.items():
        step = np32(want[name]) - np32(tp[name])
        gap = np.abs(np32(p) - np32(want[name])).max()
        assert gap <= 0.03 * np.abs(step).max() + float(bf16_ulp(np.abs(np32(tp[name])).max())), \
            name
