"""The federated LM path on the zamba2 hybrid's smoke variant against the
reference (the model itself: ``test_torch_hybrid.py``).

The setup is ``examples/federated_llm.py``'s (8 clients, m = 4, 3 rounds ×
3 local steps of batch 8 at seq 32, lr 0.05, μ 0.1) under ``heterosel``, with
the reference's initial params and per-round Gumbel noise handed over:
selection histories equal bitwise; train loss and exp(-loss) to rtol 1e-3
(the bf16 tolerance of the dense and SSM slices). The one-layer
``tail_mamba`` stack that no layer reads comes back as it went out.
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
from repro_torch.data import make_lm_data
from repro_torch.fed import FederatedSpec
from repro_torch.models import build_model

from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)
from test_torch_slice import reference_draws

ARCH = "zamba2-7b"
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


def test_hybrid_federation_matches_reference():
    jfed, fed = JaxFedConfig(**FED_KW), FedConfig(**FED_KW)
    jmodel = jax_build_model(jax_smoke_variant(jax_get_config(ARCH)))
    model = build_model(smoke_variant(get_config(ARCH)))
    jdata = jax_make_lm_data(jfed, vocab=jmodel.cfg.vocab_size, seq_len=32)
    data = make_lm_data(fed, vocab=model.cfg.vocab_size, seq_len=32)
    params, noise = reference_draws(fed.seed, fed.num_clients, ROUNDS, jmodel)
    ref = jax_run_federated(jmodel, jfed, jdata, selector="heterosel",
                            steps_per_round=STEPS)
    engine = FederatedSpec(model, fed, data, selector="heterosel", steps_per_round=STEPS,
                           executor="batched", device="cpu",
                           noise=lambda t, k: torch.from_numpy(noise[t]),
                           init_params=params).build()
    res = engine.run()
    np.testing.assert_array_equal(res.selected_history, np.asarray(ref.selected_history))
    assert res.selected_history.sum(1).tolist() == [fed.num_selected] * ROUNDS
    np.testing.assert_allclose(res.train_loss, ref.train_loss, rtol=1e-3)
    np.testing.assert_allclose(res.accuracy, ref.accuracy, rtol=1e-3)
    assert res.metric_name == ref.metric_name == "exp(-loss)"
    for name, p in res.params.items():
        assert p.dtype == params[name].dtype and bool(torch.isfinite(p).all()), name
        if name.startswith("tail_mamba."):   # never read: FedProx leaves it as it was
            assert torch.equal(p, params[name]), name
