"""The accuracy-under-traffic series of ``PublishHook`` against the JAX
reference's on a smoke federation (the serving tier's other checks are in
``test_torch_serving.py``, whose module docstring gives the tolerances)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig
from repro.data import make_lm_data as jax_make_lm_data
from repro.fed import FederatedSpec as JaxFederatedSpec
from repro.serve import PublishHook as JaxPublishHook
from repro.serve import TrafficConfig as JaxTrafficConfig
from repro_torch.data import make_lm_data
from repro_torch.fed import FederatedSpec
from repro_torch.serve import PublishHook, TrafficConfig

from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)
from test_torch_slice import reference_draws
from test_torch_serving import (FED_KW, SERVE_KW, lm_fed, models, one_torch_thread)  # noqa: F401


def test_served_metric_matches_reference(models):
    """Sync flat, bf16, the reference's initial params and Gumbel rows in
    both: the accuracy-under-traffic series of the two hooks agree."""
    jm, tm = models
    jfed, fed = JaxFedConfig(**FED_KW), lm_fed()
    jdata = jax_make_lm_data(jfed, vocab=64, seq_len=8)
    data = make_lm_data(fed, vocab=64, seq_len=8)
    params, noise = reference_draws(fed.seed, fed.num_clients, fed.rounds, jm)
    jhook = JaxPublishHook(traffic=JaxTrafficConfig(**SERVE_KW), batch_width=2, max_len=12)
    ref = JaxFederatedSpec(jm, jfed, jdata, steps_per_round=2, hooks=[jhook]).build().run()
    hook = PublishHook(traffic=TrafficConfig(**SERVE_KW), batch_width=2, max_len=12)
    res = FederatedSpec(tm, fed, data, steps_per_round=2, hooks=[hook], device="cpu",
                        noise=lambda t, k: torch.from_numpy(noise[t]),
                        init_params=params).build().run()
    np.testing.assert_array_equal(res.selected_history, np.asarray(ref.selected_history))
    assert np.array_equal(res.served_metric[:, :2], ref.served_metric[:, :2])
    np.testing.assert_allclose(res.served_metric[:, 2], ref.served_metric[:, 2], rtol=1e-3)
    for key in ("requests", "total_tokens", "versions_published", "mean_lag_rounds",
                "max_lag_rounds", "latest_version", "latest_version_round"):
        assert res.serving[key] == ref.serving[key], key
