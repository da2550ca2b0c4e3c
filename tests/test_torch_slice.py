"""The whole slice: Algorithm 1 sync/flat in the port against a live run of
the JAX reference on the quickstart configuration
(``test_engine_api.quickstart_setup``) at 3 rounds.

The reference's random draws are handed to the port: the initial params
(``init_params(PRNGKey(seed + 1))``, converted) and each round's Gumbel
noise (``key, sk = split(key); gumbel(sk, (K,))``, the array both
``sample_clients`` and ``fused_score_select`` draw). Host data comes from
the same ``np.random.default_rng(seed)`` stream in both packages.

Tolerances: the selection history must be equal, and accuracy within
2/N_test (one eval sample either way). Train loss is held to rtol 1e-3, or
to the reference's own spread where that is larger: the quickstart's
lr = 0.3 amplifies f32 rounding about a thousandfold per round, so the
reference itself moves its round-2 loss by 2.6e-3 relative when only the
execution order changes (batched vs sequential executor). Measured on this
configuration: both selectors reproduce the reference's selection history
exactly; the train-loss gap is 5e-6, 6e-4 and 1.6e-3 relative in rounds
0, 1 and 2, inside that spread.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import FedConfig as JaxFedConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_variant as jax_smoke_variant
from repro.data import make_vision_data as jax_make_vision_data
from repro.fed import run_federated as jax_run_federated
from repro.models import build_model as jax_build_model
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.data import make_vision_data
from repro_torch.fed import run_federated
from repro_torch.models import build_model


@pytest.fixture(scope="module", autouse=True)
def jax_compile_cache(tmp_path_factory):
    """JAX's persistent compilation cache while the module runs (the port's
    modules that compile reference code import it), in one directory shared
    by every module and every xdist worker of the session: the root of the
    session's temporary directories. Each run of the reference builds its
    own jitted closures, and modules build the same reference models, so
    runs and modules that differ only in selector, executor or test compile
    the same programs again; with the cache a repeat loads the executable
    compiled the first time, by whichever process, and gives the same bits
    (an entry read while another process still writes it fails to
    decompress, and JAX then compiles anew). The worker's settings come back
    after."""
    from jax.experimental.compilation_cache import compilation_cache

    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    cache = root / "jax_compile_cache"
    cache.mkdir(exist_ok=True)
    settings = {"jax_compilation_cache_dir": str(cache),
                "jax_persistent_cache_min_compile_time_secs": 0.0}
    saved = {name: getattr(jax.config, name) for name in settings}
    for name, value in settings.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()
    yield
    for name, value in saved.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores, and torch's
    threads waiting on one another under that load made these tests many
    times slower than alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROUNDS = 3
FED_KW = dict(num_clients=12, participation=0.5, rounds=ROUNDS, local_epochs=2,
              local_batch=16, lr=0.3, mu=0.1, dirichlet_alpha=0.1, seed=0)
DATA_KW = dict(train_per_class=48, test_per_class=16, noise=0.3)


def reference_draws(seed: int, k: int, rounds: int, jax_model):
    # Op by op, as the reference engine draws them (jit changes the last bits).
    params = jax.tree.map(np.array, jax_model.init_params(jax.random.PRNGKey(seed + 1)))
    key = jax.random.PRNGKey(seed)
    noise = []
    for _ in range(rounds):
        key, sk = jax.random.split(key)
        noise.append(np.array(jax.random.gumbel(sk, (k,), jnp.float32)))
    return params_from_jax(params), noise


@pytest.fixture(scope="module")
def setups():
    jfed = JaxFedConfig(**FED_KW)
    jmodel = jax_build_model(dataclasses.replace(
        jax_smoke_variant(jax_get_config("resnet18-cifar10")), d_model=8))
    jdata = jax_make_vision_data(jfed, **DATA_KW)
    fed = FedConfig(**FED_KW)
    model = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8))
    data = make_vision_data(fed, **DATA_KW)
    draws = reference_draws(fed.seed, fed.num_clients, ROUNDS, jmodel)
    return (jfed, jmodel, jdata), (fed, model, data), draws


@pytest.fixture(scope="module")
def reference(setups):
    """Reference runs by (selector, executor), each run once per module."""
    jfed, jmodel, jdata = setups[0]
    runs = {}

    def run(selector, mode="batched"):
        if (selector, mode) not in runs:
            runs[selector, mode] = jax_run_federated(
                jmodel, jfed, jdata, selector=selector, steps_per_round=4,
                client_execution=mode)
        return runs[selector, mode]

    return run


@pytest.mark.parametrize("selector", ["heterosel", "heterosel_pallas"])
def test_quickstart_matches_reference(setups, reference, selector):
    _, (fed, model, data), (params, noise) = setups
    ref = reference(selector)
    # |batched − sequential| train loss of the reference, per round.
    loss_spread = np.abs(reference("heterosel").train_loss
                         - reference("heterosel", "sequential").train_loss)
    res = run_federated(model, fed, data, selector=selector, steps_per_round=4,
                        client_execution="batched", device="cpu",
                        noise=lambda t, k: torch.from_numpy(noise[t]),
                        init_params=params)

    np.testing.assert_array_equal(res.selected_history,
                                  np.asarray(ref.selected_history))
    np.testing.assert_array_equal(res.selection_counts,
                                  np.asarray(ref.selection_counts))
    n_test = len(data.test_labels)
    np.testing.assert_allclose(res.accuracy, ref.accuracy, atol=2.0 / n_test)
    tol = np.maximum(1e-3 * np.abs(ref.train_loss), loss_spread)
    assert np.all(np.abs(res.train_loss - ref.train_loss) <= tol), (
        res.train_loss, ref.train_loss, tol)
    assert res.summary().keys() == ref.summary().keys()
    for p in res.params.values():
        assert torch.isfinite(p).all()
