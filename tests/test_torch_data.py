"""Data and partitioning of the port against the reference: bitwise.

Both packages generate the federation in numpy from the seed, so images,
labels, client index lists, label distributions and batch draws must be
equal bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig
from repro.data import make_lm_data as jax_make_lm_data
from repro.data import make_vision_data as jax_make_vision_data
from repro.fed import partition as jpartition
from repro_torch.configs.base import FedConfig
from repro_torch.data import make_lm_data, make_vision_data
from repro_torch.fed import batched, partition


@pytest.mark.parametrize("k,alpha,seed", [(12, 0.1, 0), (7, 1.0, 3)])
def test_make_vision_data_is_bitwise(k, alpha, seed):
    kw = dict(num_clients=k, dirichlet_alpha=alpha, seed=seed)
    dkw = dict(train_per_class=24, test_per_class=8, noise=0.3, image_size=16)
    ref = jax_make_vision_data(JaxFedConfig(**kw), **dkw)
    got = make_vision_data(FedConfig(**kw), **dkw)
    for name in ("images", "labels", "label_dists", "label_js",
                 "test_images", "test_labels"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.num_clients == ref.num_clients == k
    for a, b in zip(got.client_indices, ref.client_indices):
        np.testing.assert_array_equal(a, b)

    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    for c in range(k):
        bt = got.client_batches(c, 3, 4, rng_t)
        bj = ref.client_batches(c, 3, 4, rng_j)
        assert isinstance(bt["images"], torch.Tensor)
        np.testing.assert_array_equal(bt["images"].numpy(), np.asarray(bj["images"]))
        np.testing.assert_array_equal(bt["labels"].numpy(), np.asarray(bj["labels"]))
    np.testing.assert_array_equal(got.eval_batch()["labels"].numpy(),
                                  np.asarray(ref.eval_batch()["labels"]))


@pytest.mark.parametrize("k,vocab,seq_len,seed", [(8, 512, 32, 0), (5, 151936, 17, 3)])
def test_make_lm_data_is_bitwise(k, vocab, seq_len, seed):
    ref = jax_make_lm_data(JaxFedConfig(num_clients=k, seed=seed), vocab, seq_len)
    got = make_lm_data(FedConfig(num_clients=k, seed=seed), vocab, seq_len)
    assert (got.vocab, got.seq_len, got.num_clients) == (vocab, seq_len, k)
    for name in ("rules", "label_js"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    for c in range(k):
        bt = got.client_batches(c, 3, 4, rng_t)
        bj = ref.client_batches(c, 3, 4, rng_j)
        assert bt["tokens"].shape == (3, 4, seq_len) and bt["tokens"].dtype == torch.int32
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(bt[key].numpy(), np.asarray(bj[key]))
    for batch in (32, 3):
        et, ej = got.eval_batch(batch), ref.eval_batch(batch)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(et[key].numpy(), np.asarray(ej[key]))


def test_stacked_batches_consume_rng_like_per_client_draws():
    data = make_vision_data(FedConfig(num_clients=6), train_per_class=12,
                            test_per_class=4, image_size=8)
    sel = np.array([0, 2, 5])
    stacked = batched.gather_stacked_batches(data, sel, 2, 3, np.random.default_rng(1))
    rng = np.random.default_rng(1)
    for i, c in enumerate(sel):
        one = data.client_batches(int(c), 2, 3, rng)
        assert torch.equal(stacked["images"][i], one["images"])
        assert torch.equal(stacked["labels"][i], one["labels"])


def test_partition_functions_match_reference():
    labels = np.repeat(np.arange(5), 30)
    for seed in (0, 1):
        ix_t, d_t = partition.dirichlet_partition(labels, 6, 0.3, seed=seed)
        ix_j, d_j = jpartition.dirichlet_partition(labels, 6, 0.3, seed=seed)
        np.testing.assert_array_equal(d_t, d_j)
        for a, b in zip(ix_t, ix_j):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(partition.client_label_js(d_t),
                                      jpartition.client_label_js(d_j))
    p = np.random.default_rng(0).dirichlet(np.ones(4), size=3)
    np.testing.assert_array_equal(partition.js_divergence(p, p[::-1]),
                                  jpartition.js_divergence(p, p[::-1]))
    np.testing.assert_array_equal(
        partition.dirichlet_proportions(np.random.default_rng(2), 3, 4, 0.5),
        jpartition.dirichlet_proportions(np.random.default_rng(2), 3, 4, 0.5))
