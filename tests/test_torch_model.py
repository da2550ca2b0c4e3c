"""Model, FedProx client and FedAvg of the port against the reference.

Weights are the reference's ``init_params`` output carried over with
``repro_torch.convert``. Tolerances: logits atol 1e-4 (f32 convolutions
reassociate differently in XLA and PyTorch; measured gap ~1e-6 at
d_model = 8); one client visit at lr 0.01 to rtol 1e-4 (measured ~3e-6).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_variant as jax_smoke_variant
from repro.fed import client as jclient
from repro.fed import server as jserver
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.models import resnet as jresnet
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.data import make_vision_data
from repro_torch.fed import FederatedSpec, batched, client, server
from repro_torch.models import build_model, layers, resnet


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores, and torch's
    threads waiting on one another under that load made these tests many
    times slower than alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def models(d_model=8):
    jm = jax_build_model(dataclasses.replace(
        jax_smoke_variant(jax_get_config("resnet18-cifar10")), d_model=d_model))
    tm = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=d_model))
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    jm, tm = models()
    jp = jax.tree.map(np.array, jax.jit(jm.init_params)(jax.random.PRNGKey(1)))
    return jm, tm, jp, params_from_jax(jp)


def batches(steps, b, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(steps, b, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, size=(steps, b)).astype(np.int32))


def test_convert_round_trip_is_bitwise(pair):
    jm, tm, jp, tp = pair
    assert sorted(tp) == sorted(n for n, _ in tm.module.named_parameters())
    assert tuple(tp["stem"].shape) == (8, 3, 3, 3)          # OIHW
    assert tuple(tp["block2.proj"].shape) == (16, 8, 1, 1)
    back = params_to_jax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size,k,stride", [(32, 3, 1), (32, 3, 2), (16, 1, 2),
                                           (15, 3, 2), (8, 3, 2)])
def test_conv_same_padding_matches_xla(size, k, stride):
    """Stride-2 3×3 on even sizes pads (0, 1), not torch's symmetric 1."""
    rng = np.random.default_rng(size + k)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 6)).astype(np.float32)
    ref = np.asarray(jresnet._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = resnet._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w).permute(3, 2, 0, 1), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5)


def test_group_norm_matches_reference_and_vmaps():
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.normal(size=(3, 5, 5, 16))).astype(np.float32)
    wt = rng.normal(size=16).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    ref = np.asarray(jlayers.group_norm(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = layers.group_norm(xt, torch.from_numpy(wt), torch.from_numpy(b))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5)
    stacked = torch.stack([xt, 2 * xt])
    vm = torch.func.vmap(layers.group_norm, in_dims=(0, None, None))(
        stacked, torch.from_numpy(wt), torch.from_numpy(b))
    torch.testing.assert_close(vm[0], got)


def test_resnet_logits_and_loss_match_reference(pair):
    jm, tm, jp, tp = pair
    imgs, labels = batches(1, 6)
    batch_j = {"images": jnp.asarray(imgs[0]), "labels": jnp.asarray(labels[0])}
    batch_t = {"images": torch.from_numpy(imgs[0]), "labels": torch.from_numpy(labels[0])}
    logits = tm.forward(tp, batch_t)
    assert logits.shape == (6, 10)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jm.forward(jp, batch_j)), atol=1e-4)
    np.testing.assert_allclose(float(tm.loss(tp, batch_t)),
                               float(jm.loss(jp, batch_j)), rtol=1e-5)


def test_init_params_shapes_and_seed():
    _, tm = models()
    p1 = tm.init_params(torch.Generator().manual_seed(0))
    p2 = tm.init_params(torch.Generator().manual_seed(0))
    names = [n for n, _ in tm.module.named_parameters()]
    assert list(p1) == names
    for n, p in tm.module.named_parameters():
        assert p1[n].shape == p.shape and torch.equal(p1[n], p2[n])
    assert torch.equal(p1["gn_stem.scale"], torch.ones(8))
    # He-normal stem: std sqrt(2 / 27)
    assert abs(float(p1["block6.conv2"].std()) - (2 / (9 * 64)) ** 0.5) < 0.01


def test_local_train_matches_reference(pair):
    jm, tm, jp, tp = pair
    imgs, labels = batches(3, 8)
    res_j = jax.jit(lambda p, b: jclient.local_train(jm.loss, p, b, lr=0.01, mu=0.1))(
        jp, {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)})
    res_t = client.local_train(tm.loss, tp, {"images": torch.from_numpy(imgs),
                                             "labels": torch.from_numpy(labels)},
                               lr=0.01, mu=0.1)
    np.testing.assert_allclose(float(res_t.mean_loss), float(res_j.mean_loss), rtol=1e-4)
    np.testing.assert_allclose(float(res_t.last_loss), float(res_j.last_loss), rtol=1e-4)
    np.testing.assert_allclose(float(res_t.update_sqnorm),
                               float(res_j.update_sqnorm), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(params_to_jax(res_t.params)),
                    jax.tree.leaves(res_j.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)


def test_batched_train_equals_per_client_visits(pair):
    """vmap over the cohort computes the per-client visits; the chunked and
    padded paths give the same aggregate."""
    _, tm, _, tp = pair
    imgs, labels = batches(3 * 2, 4, size=16, seed=1)
    stacked = {"images": torch.from_numpy(imgs.reshape(3, 2, 4, 16, 16, 3)),
               "labels": torch.from_numpy(labels.reshape(3, 2, 4))}
    train = batched.make_batched_local_train(tm.loss, lr=0.05, mu=0.1)
    full = batched.train_clients_batched(train, tp, stacked, keep_client_params=True)
    for i in range(3):
        one = client.local_train(tm.loss, tp, {k: v[i] for k, v in stacked.items()},
                                 lr=0.05, mu=0.1)
        torch.testing.assert_close(full.mean_loss[i], one.mean_loss, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(full.stacked_params["fc_w"][i], one.params["fc_w"],
                                   rtol=1e-5, atol=1e-6)
    for kw in (dict(chunk=2), dict(pad_to=2)):
        other = batched.train_clients_batched(train, tp, stacked, **kw)
        torch.testing.assert_close(other.mean_loss, full.mean_loss)
        for k in full.avg_params:
            torch.testing.assert_close(other.avg_params[k], full.avg_params[k],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_fedavg_fused_matches_reference(weighted):
    rng = np.random.default_rng(4)
    stacked = {"a": rng.normal(size=(5, 3, 4)).astype(np.float32),
               "b": rng.normal(size=(5, 7)).astype(np.float32)}
    w = rng.uniform(0.5, 2, 5).astype(np.float32) if weighted else None
    ref = jserver.fedavg_fused({k: jnp.asarray(v) for k, v in stacked.items()},
                               None if w is None else jnp.asarray(w))
    got = server.fedavg_fused({k: torch.from_numpy(v) for k, v in stacked.items()},
                              None if w is None else torch.from_numpy(w))
    for k in stacked:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-6)
    lst = [{k: torch.from_numpy(v[i]) for k, v in stacked.items()} for i in range(5)]
    if not weighted:
        for k in stacked:
            np.testing.assert_allclose(server.fedavg(lst)[k].numpy(), got[k].numpy(),
                                       rtol=1e-6, atol=1e-6)


def test_engine_refuses_what_is_not_ported():
    """The 'filtered' selector and the telemetry hook (slice 10) raise;
    async rounds and 'fedbuff', refused until slice 8, now build."""
    from repro_torch.fed import AsyncFederatedEngine, BufferedAggregator

    _, tm = models()
    fed = FedConfig(num_clients=4, rounds=1)
    data = make_vision_data(fed, train_per_class=4, test_per_class=2, image_size=8)
    hier = dataclasses.replace(fed, topology="hierarchical", edge_count=2)
    for f in (fed, hier):
        with pytest.raises(ValueError, match="not yet ported"):
            FederatedSpec(tm, f, data, device="cpu", selector="filtered").build()
    with pytest.raises(ValueError, match="unknown hook"):
        FederatedSpec(tm, fed, data, device="cpu", hooks=["telemetry"]).build()
    assert isinstance(FederatedSpec(tm, fed, data, device="cpu",
                                    round_policy="async").build(), AsyncFederatedEngine)
    eng = FederatedSpec(tm, fed, data, device="cpu", aggregator="fedbuff").build()
    assert isinstance(eng.aggregator, BufferedAggregator)


def test_sequential_and_batched_executors_agree(capsys):
    _, tm = models()
    fed = FedConfig(num_clients=6, participation=0.5, rounds=2, local_batch=4,
                    lr=0.05, seed=1)
    data = make_vision_data(fed, train_per_class=8, test_per_class=4, image_size=16)
    runs = [FederatedSpec(tm, fed, data, selector="heterosel_pallas",
                          steps_per_round=2, executor=ex, device="cpu",
                          verbose=ex == "sequential").build().run()
            for ex in ("batched", "sequential")]
    np.testing.assert_array_equal(runs[0].selected_history, runs[1].selected_history)
    np.testing.assert_allclose(runs[0].train_loss, runs[1].train_loss, rtol=1e-4)
    assert runs[0].selected_history.sum(1).tolist() == [3, 3]
    assert set(runs[0].summary()) == {"peak_acc", "final_acc", "stable_acc",
                                      "stability_drop", "selection_std"}
    printed = capsys.readouterr().out.splitlines()
    assert [line.split()[1] for line in printed] == ["0", "1"]
    assert all("accuracy=" in line and "heterosel_pallas" in line for line in printed)
