"""The MoE federated slice against the reference (``test_torch_moe.py``
holds the model-level parity): the smoke kimi-k2 federation under
``heterosel`` and ``heterosel_pallas`` (bf16) and in f32, each against the
reference's sequential executor (ROADMAP queue 3 (h)), and the public entry
point on the moe family."""

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
from repro.models import moe as jmoe
from repro_torch.configs import FedConfig, get_config, smoke_variant
from repro_torch.data import make_lm_data
from repro_torch.fed import FederatedSpec, run_federated
from repro_torch.fed.engine import default_eval
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.models import build_model, moe

from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)
from test_torch_slice import reference_draws
from test_torch_moe import ARCH, FED_KW, ROUNDS, STEPS, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def setups():
    jfed, fed = JaxFedConfig(**FED_KW), FedConfig(**FED_KW)
    jmodel = jax_build_model(jax_smoke_variant(jax_get_config(ARCH)))
    model = build_model(smoke_variant(get_config(ARCH)))
    jdata = jax_make_lm_data(jfed, vocab=jmodel.cfg.vocab_size, seq_len=32)
    data = make_lm_data(fed, vocab=model.cfg.vocab_size, seq_len=32)
    draws = reference_draws(fed.seed, fed.num_clients, ROUNDS, jmodel)
    return (jfed, jmodel, jdata), (fed, model, data), draws


def _federate(setups, selector, params, jmodel=None):
    (jfed, jm, jdata), (fed, model, data), (_, noise) = setups
    ref = jax_run_federated(jmodel or jm, jfed, jdata, selector=selector,
                            steps_per_round=STEPS, client_execution="sequential")
    tfa.reset_launches()
    tgmm.reset_launches()
    engine = FederatedSpec(model, fed, data, selector=selector, steps_per_round=STEPS,
                           executor="batched", device="cpu",
                           noise=lambda t, k: torch.from_numpy(noise[t]),
                           init_params=params).build()
    assert engine.metric_name == "exp(-loss)"
    res = engine.run()
    np.testing.assert_array_equal(res.selected_history, np.asarray(ref.selected_history))
    assert res.selected_history.sum(1).tolist() == [fed.num_selected] * ROUNDS
    assert res.metric_name == ref.metric_name == "exp(-loss)"
    # CPU tensors take the plain versions
    assert tfa.LAUNCHES["flash_attention"] == tgmm.LAUNCHES["grouped_matmul"] == 0
    for name, p in res.params.items():
        assert p.dtype == params[name].dtype and bool(torch.isfinite(p).all()), name
    return res, ref


@pytest.mark.parametrize("selector", ["heterosel", "heterosel_pallas"])
def test_moe_federation_matches_reference(setups, selector):
    res, ref = _federate(setups, selector, setups[2][0])
    np.testing.assert_allclose(res.train_loss, ref.train_loss, rtol=1e-4)
    np.testing.assert_allclose(res.accuracy, ref.accuracy, rtol=1e-3)


def test_moe_federation_matches_reference_in_f32(setups, monkeypatch):
    monkeypatch.setattr(jmoe, "DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(moe, "DEFAULT_DTYPE", torch.float32)
    jm = setups[0][1]
    jm32 = dataclasses.replace(jm, init_params=lambda key: jax.tree.map(
        lambda a: a.astype(jnp.float32), jm.init_params(key)))
    params32 = {k: v.to(torch.float32) for k, v in setups[2][0].items()}
    res, ref = _federate(setups, "heterosel", params32, jmodel=jm32)
    np.testing.assert_allclose(res.train_loss, ref.train_loss, rtol=1e-5)
    np.testing.assert_allclose(res.accuracy, ref.accuracy, rtol=1e-4)


def test_run_federated_takes_the_moe_family():
    """The public entry point on a tiny run: exp(-loss) in (0, 1], named so,
    and the eval is exp(-loss) of the model's loss (aux included) unchanged."""
    model = build_model(dataclasses.replace(smoke_variant(get_config(ARCH)), num_layers=1))
    fed = FedConfig(num_clients=4, participation=0.5, rounds=2, local_epochs=1,
                    local_batch=2, lr=0.05, seed=0)
    data = make_lm_data(fed, vocab=model.cfg.vocab_size, seq_len=8)
    res = run_federated(model, fed, data, selector="heterosel_pallas", device="cpu")
    assert res.metric_name == "exp(-loss)"
    assert np.all((res.accuracy > 0) & (res.accuracy <= 1))
    assert "peak_exp(-loss)" in res.labeled_summary()
    eval_batch = data.eval_batch()
    assert default_eval(model, res.params, eval_batch) == pytest.approx(
        float(torch.exp(-model.loss(res.params, eval_batch))), rel=0, abs=0)
