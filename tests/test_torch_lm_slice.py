"""The federated LM path: Algorithm 1 sync/flat on the dense decoder, in the
port against a live run of the JAX reference, at the setup of
``examples/federated_llm.py`` (8 clients, m = 4, 1 local epoch of 3 steps,
batch 8, lr 0.05, μ 0.1, ``make_lm_data(seq_len=32)``) on
``smoke_variant(qwen2-0.5b)`` in its default bf16, for 3 rounds.

The reference's random draws are handed to the port as in
``test_torch_slice.reference_draws``: the initial params and each round's
Gumbel noise. Host data comes from the same numpy streams in both packages.

Tolerances: selection histories equal. Train loss and the exp(-loss) eval
metric to rtol 1e-3: both packages round bf16 matmuls at their own places
(measured gaps ≤ 1e-5 relative on the loss and ≤ 2e-4 on the metric).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_variant as jax_smoke_variant
from repro.data import make_lm_data as jax_make_lm_data
from repro.fed import run_federated as jax_run_federated
from repro.models import build_model as jax_build_model
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.data import make_lm_data, make_vision_data
from repro_torch.fed import FederatedSpec, run_federated
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import build_model

from test_torch_slice import reference_draws

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
def setups():
    jfed, fed = JaxFedConfig(**FED_KW), FedConfig(**FED_KW)
    jmodel = jax_build_model(jax_smoke_variant(jax_get_config("qwen2-0.5b")))
    model = build_model(smoke_variant(get_config("qwen2-0.5b")))
    jdata = jax_make_lm_data(jfed, vocab=jmodel.cfg.vocab_size, seq_len=32)
    data = make_lm_data(fed, vocab=model.cfg.vocab_size, seq_len=32)
    draws = reference_draws(fed.seed, fed.num_clients, ROUNDS, jmodel)
    return (jfed, jmodel, jdata), (fed, model, data), draws


@pytest.mark.parametrize("selector", ["heterosel", "heterosel_pallas"])
def test_lm_federation_matches_reference(setups, selector):
    (jfed, jmodel, jdata), (fed, model, data), (params, noise) = setups
    ref = jax_run_federated(jmodel, jfed, jdata, selector=selector,
                            steps_per_round=STEPS)
    tfa.reset_launches()
    res = run_federated(model, fed, data, selector=selector, steps_per_round=STEPS,
                        client_execution="batched", device="cpu",
                        noise=lambda t, k: torch.from_numpy(noise[t]),
                        init_params=params)

    np.testing.assert_array_equal(res.selected_history, np.asarray(ref.selected_history))
    assert res.selected_history.sum(1).tolist() == [fed.num_selected] * ROUNDS
    np.testing.assert_allclose(res.train_loss, ref.train_loss, rtol=1e-3)
    np.testing.assert_allclose(res.accuracy, ref.accuracy, rtol=1e-3)
    assert res.metric_name == ref.metric_name == "exp(-loss)"
    assert res.labeled_summary().keys() == ref.labeled_summary().keys()
    assert tfa.LAUNCHES["flash_attention"] == 0   # CPU tensors take the plain version
    for name, p in res.params.items():
        assert p.dtype == params[name].dtype and bool(torch.isfinite(p).all()), name


class TestMetricNaming:
    """As the reference's ``test_engine_api.TestMetricNaming``: the eval
    metric is named for what it is."""

    def test_resnet_metric_is_accuracy(self):
        fed = FedConfig(num_clients=4, rounds=2, local_batch=4)
        model = build_model(smoke_variant(get_config("resnet18-cifar10")))
        data = make_vision_data(fed, train_per_class=4, test_per_class=2, image_size=8)
        engine = FederatedSpec(model, fed, data, device="cpu").build()
        assert engine.metric_name == "accuracy"
        res = FederatedSpec(model, fed, data, selector="heterosel", steps_per_round=1,
                            device="cpu").build().run()
        ls = res.labeled_summary()
        assert res.metric_name == "accuracy"
        assert ls["peak_accuracy"] == res.summary()["peak_acc"]
        assert ls["final_accuracy"] == res.summary()["final_acc"]

    def test_lm_metric_is_not_called_accuracy(self):
        model = build_model(smoke_variant(get_config("qwen2-0.5b")))
        fed = FedConfig(num_clients=4, rounds=2)
        data_stub = type("D", (), {"num_clients": 4,
                                   "label_js": np.zeros(4, np.float32)})()
        engine = FederatedSpec(model, fed, data_stub, device="cpu").build()
        assert engine.metric_name == "exp(-loss)"

    def test_lm_labeled_summary_names_metric(self):
        model = build_model(smoke_variant(get_config("qwen2-0.5b")))
        fed = FedConfig(num_clients=4, participation=0.5, rounds=2, local_epochs=1,
                        local_batch=2, lr=0.05, seed=0)
        data = make_lm_data(fed, vocab=model.cfg.vocab_size, seq_len=8)
        res = run_federated(model, fed, data, selector="heterosel", device="cpu")
        ls = res.labeled_summary()
        assert "peak_exp(-loss)" in ls and "final_exp(-loss)" in ls
        assert ls["peak_exp(-loss)"] == res.summary()["peak_acc"]
        assert np.all((res.accuracy > 0) & (res.accuracy <= 1))
