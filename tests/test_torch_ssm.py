"""The mamba2 decoder (ssm family) of the port against the reference, and the
federated LM path on it.

Model: ``smoke_variant(mamba2-370m)``: 2 layers, d_model 256, d_inner 512,
state 16, head dim 32 (16 heads), chunk 32, vocab 512, tied embeddings.
Weights are the reference's ``init_params`` output carried with
``repro_torch.convert``; inputs are drawn with numpy from a seed. The full
width is checked by names, shapes and dtypes only (``jax.eval_shape``).

Tolerances:
  * Layers in f32 (conv, softplus): 1e-6 relative.
  * The whole model with every dtype f32 (both packages' DEFAULT_DTYPE
    patched to float32: the reference's bf16 layer carry cannot hold the f32
    residuals that f32 weights produce): logits atol 1e-5 (measured 1.5e-6),
    loss rtol 1e-6, gradients within 1e-5 of each leaf's largest entry
    (measured 1.8e-6). The SSD's cum is
    summed in f64 in the port (``kernels.ssd_scan.chunk_cumsum``) and in f32
    in the reference; everything else differs by the order of f32 sums.
  * In the default bf16: logits within 4 bf16 ulp of the largest logit,
    loss rtol 1e-3, gradients within 3 % of each leaf's largest entry
    (measured 1.6 ulp, 4.3e-5 and 1.6 %): each package rounds every bf16
    product at its own places.
  * The federated slice at ``examples/federated_llm.py``'s setup (8 clients,
    m = 4, 3 rounds × 3 steps, batch 8, seq 32), with the reference's initial
    params and per-round Gumbel noise handed over: selection histories equal;
    train loss and exp(-loss) to rtol 1e-3 (the bf16 tolerance of the dense
    slice).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import FedConfig as JaxFedConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_variant as jax_smoke_variant
from repro.data import make_lm_data as jax_make_lm_data
from repro.fed import run_federated as jax_run_federated
from repro.models import build_model as jax_build_model
from repro.models import mamba2 as jmamba
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.data import make_lm_data
from repro_torch.fed import FederatedSpec, run_federated
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import build_model, mamba2

from test_torch_flash import bf16_ulp, np32
from test_torch_slice import reference_draws

ARCH = "mamba2-370m"
ROUNDS = 3
STEPS = 3
FED_KW = dict(num_clients=8, participation=0.5, rounds=ROUNDS, local_epochs=1,
              local_batch=8, lr=0.05, mu=0.1, seed=0)


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
    jp = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(1)))
    return jm, tm, jp, params_from_jax(jp)


def batch(cfg, b=2, s=40, seed=0):
    """Tokens of a length that is not a multiple of the chunk (32)."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return ({"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)},
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})


def test_configs_are_the_reference_configs():
    full, want = get_config(ARCH), jax_get_config(ARCH)
    smoke, want_smoke = smoke_variant(full), jax_smoke_variant(want)
    for f in dataclasses.fields(full):
        assert getattr(full, f.name) == getattr(want, f.name), f.name
        assert getattr(smoke, f.name) == getattr(want_smoke, f.name), f.name
    assert (full.num_layers, full.d_model, full.d_inner, full.ssm_state, full.ssm_heads,
            full.ssm_headdim, full.ssm_chunk, full.padded_vocab) == \
        (48, 1024, 2048, 128, 32, 64, 256, 50432)
    assert (smoke.num_layers, smoke.d_model, smoke.ssm_state, smoke.ssm_heads,
            smoke.ssm_headdim, smoke.ssm_chunk, smoke.vocab_size) == (2, 256, 16, 16, 32, 32, 512)


def test_full_width_names_shapes_dtypes_match_reference():
    """At full width, without arrays: the reference's ``init_params`` traced
    by ``jax.eval_shape`` against the port's meta-device module."""
    cfg = get_config(ARCH)
    jcfg = jax_get_config(ARCH)
    shapes = jax.eval_shape(lambda k: jmamba.init_params(k, jcfg), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(path, simple=True, separator="."): (tuple(a.shape),
                                                                       str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in build_model(cfg).module.named_parameters()}
    assert got == want
    n_params = sum(int(np.prod(s)) for s, _ in got.values())
    n_bytes = sum(int(np.prod(s)) * (2 if d == "bfloat16" else 4) for s, d in got.values())
    assert (n_params, n_bytes) == (368_494_080, 738_400_256)


def test_smoke_names_shapes_dtypes_match_reference_and_init(pair):
    jm, tm, jp, tp = pair
    named = {n: (tuple(p.shape), p.dtype) for n, p in tm.module.named_parameters()}
    assert named == {n: (tuple(t.shape), t.dtype) for n, t in tp.items()}
    assert named["layers.block.conv_x_w"] == ((2, 4, 512), torch.float32)
    init = tm.init_params(torch.Generator().manual_seed(3))
    assert {n: (tuple(t.shape), t.dtype) for n, t in init.items()} == named
    again = tm.init_params(torch.Generator().manual_seed(3))
    assert all(torch.equal(init[n], again[n]) for n in init)
    for name, value in (("A_log", 0.0), ("D", 1.0), ("dt_bias", -2.0), ("norm", 1.0),
                        ("conv_x_b", 0.0), ("conv_bc_b", 0.0)):
        assert bool((init[f"layers.block.{name}"] == value).all()), name
        np.testing.assert_array_equal(np.asarray(jp["layers"]["block"][name]), value)
    # Truncated normal at 2σ, σ = 1/√fan_in (fan-in 4 for the conv kernels).
    assert float(init["layers.block.in_x"].float().abs().max()) <= 2.0 / 16 + 1e-3
    assert float(init["layers.block.conv_x_w"].abs().max()) <= 1.0 + 1e-6


def test_convert_round_trip_is_bitwise(pair):
    _, _, jp, tp = pair
    assert tuple(tp["layers.block.conv_x_w"].shape) == jp["layers"]["block"]["conv_x_w"].shape
    assert tuple(tp["layers.block.out_proj"].shape) == jp["layers"]["block"]["out_proj"].shape
    back = params_to_jax(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=str(path))


def test_causal_conv_and_softplus_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = mamba2._causal_conv(xb, torch.from_numpy(w), torch.from_numpy(b))
    want = jmamba._causal_conv(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                               jnp.asarray(w), jnp.asarray(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # F.softplus's threshold 20 against jax.nn.softplus, across it and far past it.
    v = np.concatenate([np.linspace(-30, 40, 7001), [19.999, 20.0, 20.001, 88.0]]
                       ).astype(np.float32)
    np.testing.assert_allclose(torch.nn.functional.softplus(torch.from_numpy(v)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(v))), rtol=2e-7,
                               atol=0)


def _grads_close(got, want_tree, frac):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    for name in sorted(got):
        g, w = np32(got[name]), np32(want[name])
        assert got[name].dtype == want[name].dtype, name
        gap, scale = np.abs(g - w).max(), np.abs(w).max()
        assert gap <= frac * scale, (name, float(gap), float(scale))


def test_forward_loss_and_grads_match_reference_in_f32(pair, monkeypatch):
    monkeypatch.setattr(jmamba, "DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(mamba2, "DEFAULT_DTYPE", torch.float32)
    jm, tm, jp, tp = pair
    jp32 = jax.tree.map(lambda a: a.astype(np.float32), jp)
    tp32 = {k: v.to(torch.float32) for k, v in tp.items()}
    tb, jb = batch(tm.cfg)
    logits = tm.forward(tp32, tb)
    want = np.asarray(jm.forward(jp32, jb))
    assert logits.dtype == torch.float32 and logits.shape == (2, 40, 512)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-5)
    loss, grads = torch.func.grad_and_value(tm.loss)(tp32, tb)[::-1]
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp32, jb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    _grads_close(grads, jgrads, 1e-5)
    assert tssd.LAUNCHES["ssd_chunk"] == 0


def test_forward_loss_and_grads_match_reference_in_bf16(pair):
    jm, tm, jp, tp = pair
    tb, jb = batch(tm.cfg, seed=1)
    logits = tm.forward(tp, tb)
    want = np32(jm.forward(jp, jb))
    assert logits.dtype == torch.bfloat16
    assert np.abs(np32(logits) - want).max() <= 4 * bf16_ulp(np.abs(want).max())
    loss, grads = torch.func.grad_and_value(tm.loss)(tp, tb)[::-1]
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    _grads_close(grads, jgrads, 0.03)


# ---------------------------------------------------------------------------
# The federated slice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setups():
    jfed, fed = JaxFedConfig(**FED_KW), FedConfig(**FED_KW)
    jmodel = jax_build_model(jax_smoke_variant(jax_get_config(ARCH)))
    model = build_model(smoke_variant(get_config(ARCH)))
    jdata = jax_make_lm_data(jfed, vocab=jmodel.cfg.vocab_size, seq_len=32)
    data = make_lm_data(fed, vocab=model.cfg.vocab_size, seq_len=32)
    draws = reference_draws(fed.seed, fed.num_clients, ROUNDS, jmodel)
    return (jfed, jmodel, jdata), (fed, model, data), draws


@pytest.mark.parametrize("selector", ["heterosel", "heterosel_pallas"])
def test_ssm_federation_matches_reference(setups, selector):
    (jfed, jmodel, jdata), (fed, model, data), (params, noise) = setups
    ref = jax_run_federated(jmodel, jfed, jdata, selector=selector,
                            steps_per_round=STEPS)
    tssd.reset_launches()
    engine = FederatedSpec(model, fed, data, selector=selector, steps_per_round=STEPS,
                           executor="batched", device="cpu",
                           noise=lambda t, k: torch.from_numpy(noise[t]),
                           init_params=params).build()
    assert engine.metric_name == "exp(-loss)"
    res = engine.run()

    np.testing.assert_array_equal(res.selected_history, np.asarray(ref.selected_history))
    assert res.selected_history.sum(1).tolist() == [fed.num_selected] * ROUNDS
    np.testing.assert_allclose(res.train_loss, ref.train_loss, rtol=1e-3)
    np.testing.assert_allclose(res.accuracy, ref.accuracy, rtol=1e-3)
    assert res.metric_name == ref.metric_name == "exp(-loss)"
    assert tssd.LAUNCHES["ssd_chunk"] == 0   # CPU tensors take the plain version
    for name, p in res.params.items():
        assert p.dtype == params[name].dtype and bool(torch.isfinite(p).all()), name


def test_run_federated_takes_the_ssm_family():
    """The public entry point on a tiny run: exp(-loss) in (0, 1], named so."""
    model = build_model(dataclasses.replace(smoke_variant(get_config(ARCH)), num_layers=1))
    fed = FedConfig(num_clients=4, participation=0.5, rounds=2, local_epochs=1,
                    local_batch=2, lr=0.05, seed=0)
    data = make_lm_data(fed, vocab=model.cfg.vocab_size, seq_len=8)
    res = run_federated(model, fed, data, selector="heterosel_pallas", device="cpu")
    assert res.metric_name == "exp(-loss)"
    assert np.all((res.accuracy > 0) & (res.accuracy <= 1))
    assert "peak_exp(-loss)" in res.labeled_summary()
