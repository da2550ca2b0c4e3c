"""Update compression in the port (``repro_torch.fed.compression`` and
``fed.engine.CompressedExecutor``) against the JAX reference.

The codecs on the same deltas: int8 codes and scales bitwise (per tensor
and per client over a stacked cohort, values on the .5 rounding boundary
included), top-k with error feedback bitwise over a chain of rounds, on
random deltas and on a tie-heavy case (zeros and repeated magnitudes, where
``lax.top_k``'s order decides which entries are sent and so the residual).
Then a smoke federation with top-k (K = 6, 2 rounds, one local step, over
the sequential executor in both packages, the reference's run once for the
module): histories equal, accuracy within 2/N_test, train loss rtol 1e-3
(``test_torch_slice.py``'s bound), ``wire_bytes``/``raw_bytes`` equal, and
the snapshot's wire-byte counters read across the two packages. int8 in
the engine (over the port's batched executor) is held to the reference in
``test_torch_obs.py``'s federation.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import ckpt as jckpt
from repro.configs.base import FedConfig as JaxFedConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_variant as jax_smoke_variant
from repro.data import make_vision_data as jax_make_vision_data
from repro.fed import CheckpointHook as JaxCheckpointHook
from repro.fed import FederatedSpec as JaxSpec
from repro.fed import compression as jcomp
from repro.models import build_model as jax_build_model
from repro_torch import ckpt as tckpt
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.data import make_vision_data
from repro_torch.fed import (AsyncConfig, CheckpointHook, CompressedExecutor,
                             ExecutorCompatError, FederatedSpec, HierarchyConfig,
                             KillAtRound, SimulatedPreemption, run_federated)
from repro_torch.fed import compression as comp
from repro_torch.models import build_model
from test_torch_slice import jax_compile_cache, reference_draws  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SHAPES = {"conv": (3, 3, 4, 8), "b": (13,), "w": (5, 7)}


def deltas(seed, ties=False, lead=()):
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in SHAPES.items():
        s = lead + s
        if ties:  # zeros and a few repeated magnitudes, both signs
            x = rng.choice(np.float32([0.0, 0.0, 0.5, -0.5, 1.0, -1.0, 0.25, -0.0]), size=s)
        else:
            x = rng.normal(size=s).astype(np.float32) * rng.uniform(1e-3, 1.0)
        out[name] = x.astype(np.float32)
    return out


def on_the_boundary(lead=()):
    """Leaves whose codes all sit on .5 boundaries: max |x| = 127·2⁻⁴, so the
    scale is exactly 2⁻⁴ and x / scale = k + 0.5 exactly."""
    out = {}
    for name, s in SHAPES.items():
        n = int(np.prod(lead + s))
        k = np.arange(n) % 127 - 63
        x = ((k + 0.5) * 2.0 ** -4).astype(np.float32)
        x[0] = 127 * 2.0 ** -4
        out[name] = x.reshape(lead + s)
    return out


def bits(x):
    return np.atleast_1d(np.asarray(x)).view(np.uint8)


def to_t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def to_j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("case", ["random", "small", "boundary"])
def test_int8_codes_match_reference_bitwise(case):
    d = {"random": deltas(0), "small": deltas(1), "boundary": on_the_boundary()}[case]
    if case == "small":
        d = {k: v * np.float32(1e-9) for k, v in d.items()}
    cj, sj = jcomp.quantize_int8(to_j(d))
    ct, st = comp.quantize_int8(to_t(d))
    assert tuple(st) == tuple(sj) and ct.kind == cj.kind == "int8"
    for k in SHAPES:
        np.testing.assert_array_equal(ct.payload[k].numpy(), np.asarray(cj.payload[k]), k)
        assert ct.payload[k].dtype == torch.int8
        np.testing.assert_array_equal(bits(ct.meta[k].numpy()), bits(cj.meta[k]), k)
    dj, dt = jcomp.dequantize_int8(cj), comp.dequantize_int8(ct)
    for k in SHAPES:
        np.testing.assert_array_equal(bits(dt[k].numpy()), bits(dj[k]), k)
    if case == "boundary":  # half to even, as jnp.round
        codes = ct.payload["w"].numpy().ravel()[1:]  # [0] is the max: 127
        assert not (codes % 2).any()


@pytest.mark.parametrize("case", ["random", "boundary"])
def test_int8_stacked_matches_reference_and_each_client(case):
    d = deltas(2, lead=(4,)) if case == "random" else on_the_boundary(lead=(4,))
    cj, sj = jcomp.quantize_int8_stacked(to_j(d))
    ct, st = comp.quantize_int8_stacked(to_t(d))
    assert tuple(st) == tuple(sj)
    for k in SHAPES:
        np.testing.assert_array_equal(ct.payload[k].numpy(), np.asarray(cj.payload[k]), k)
        np.testing.assert_array_equal(bits(ct.meta[k].numpy()), bits(cj.meta[k]), k)
        for m in range(4):  # client m's codes are the per-client codec's
            one, _ = comp.quantize_int8({k: torch.from_numpy(d[k][m])})
            assert torch.equal(one.payload[k], ct.payload[k][m])
    dj, dt = jcomp.dequantize_int8_stacked(cj), comp.dequantize_int8_stacked(ct)
    for k in SHAPES:
        np.testing.assert_array_equal(bits(dt[k].numpy()), bits(dj[k]), k)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("frac", [0.1, 0.3])
def test_topk_error_feedback_matches_reference_bitwise(ties, frac):
    """Three rounds of one client's top-k with error feedback: sent indices
    (in the reference's order), values, residuals and stats equal."""
    rj = rt = None
    sent_j, sent_t = [], []
    for r in range(3):
        d = deltas(10 + r, ties=ties)
        cj, rj, sj = jcomp.topk_sparsify(to_j(d), frac, rj)
        ct, rt, st = comp.topk_sparsify(to_t(d), frac, rt)
        assert tuple(st) == tuple(sj)
        for k in SHAPES:
            (vj, ij), (vt, it) = cj.payload[k], ct.payload[k]
            np.testing.assert_array_equal(it.numpy(), np.asarray(ij), f"round {r} {k}")
            assert it.dtype == torch.int32
            np.testing.assert_array_equal(bits(vt.numpy()), bits(vj), f"round {r} {k}")
            np.testing.assert_array_equal(bits(rt[k].numpy()), bits(rj[k]), f"round {r} {k}")
        dj, dt = jcomp.desparsify(cj), comp.desparsify(ct)
        for k in SHAPES:
            np.testing.assert_array_equal(bits(dt[k].numpy()), bits(dj[k]), k)
        sent_j.append(cj)
        sent_t.append(ct)
    if ties:  # the case exercises ties: equal magnitudes straddle the cut
        flat = np.abs(deltas(10, ties=True)["conv"].ravel())
        kth = np.sort(flat)[::-1][max(int(flat.size * frac), 1) - 1]
        assert (flat == kth).sum() > 1
    anchor = deltas(20)
    aj = jcomp.aggregate_compressed(to_j(anchor), sent_j)
    at = comp.aggregate_compressed(to_t(anchor), sent_t)
    for k in SHAPES:
        np.testing.assert_array_equal(bits(at[k].numpy()), bits(aj[k]), k)


def test_delta_helpers_keep_dtypes():
    anchor = {"w": torch.ones(3, dtype=torch.bfloat16), "b": torch.zeros(2)}
    new = {"w": torch.full((3,), 1.5, dtype=torch.bfloat16), "b": torch.ones(2)}
    d = comp.tree_delta(new, anchor)
    assert all(v.dtype == torch.float32 for v in d.values())
    back = comp.tree_apply_delta(anchor, d)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], new["w"])
    stats = comp.CompressionStats(raw_bytes=100, wire_bytes=25)
    assert stats.ratio == jcomp.CompressionStats(100, 25).ratio == 4.0


# ---------------------------------------------------------------------------
# CompressedExecutor in the engines
# ---------------------------------------------------------------------------

ROUNDS = 2
FED_KW = dict(num_clients=6, participation=0.5, rounds=ROUNDS, local_epochs=1,
              local_batch=8, lr=0.05, mu=0.1, dirichlet_alpha=0.1, seed=0)
DATA_KW = dict(train_per_class=24, test_per_class=8, noise=0.3, image_size=8)
# case: (codec, the port's executor, the reference's executor)
CASES = {"topk-sequential": ("topk", "sequential", "sequential")}


@pytest.fixture(scope="module")
def setups():
    jfed = JaxFedConfig(**FED_KW)
    jmodel = jax_build_model(dataclasses.replace(
        jax_smoke_variant(jax_get_config("resnet18-cifar10")), d_model=8, image_size=8))
    jdata = jax_make_vision_data(jfed, **DATA_KW)
    fed = FedConfig(**FED_KW)
    model = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8, image_size=8))
    data = make_vision_data(fed, **DATA_KW)
    draws = reference_draws(fed.seed, fed.num_clients, ROUNDS, jmodel)
    return (jfed, jmodel, jdata), (fed, model, data), draws


@pytest.fixture(scope="module")
def reference(setups, tmp_path_factory):
    """The reference's compressed runs by case, each once per module, with
    its snapshots: ``case -> (result, checkpoint dir)``."""
    jfed, jmodel, jdata = setups[0]
    runs = {}

    def run(case):
        if case not in runs:
            codec, _, executor = CASES[case]
            ck = str(tmp_path_factory.mktemp("ref_ck"))
            res = JaxSpec(jmodel, jfed, jdata, selector="heterosel", steps_per_round=1,
                          compression=codec, topk_frac=0.1, executor=executor,
                          hooks=[JaxCheckpointHook(ck)]).build().run()
            runs[case] = (res, ck)
        return runs[case]

    return run


@pytest.mark.parametrize("case", list(CASES))
def test_compressed_executor_matches_reference(setups, reference, case, tmp_path):
    _, (fed, model, data), (params, noise) = setups
    codec, executor, _ = CASES[case]
    ref, ref_ck = reference(case)
    eng = FederatedSpec(model, fed, data, selector="heterosel", steps_per_round=1,
                        compression=codec, topk_frac=0.1, executor=executor,
                        device="cpu", init_params=params, hooks=[CheckpointHook(str(tmp_path))],
                        noise=lambda t, k: torch.from_numpy(noise[t])).build()
    assert isinstance(eng.executor, CompressedExecutor) and eng.executor.kind == executor
    res = eng.run()
    np.testing.assert_array_equal(res.selected_history, np.asarray(ref.selected_history))
    assert (res.wire_bytes, res.raw_bytes) == (ref.wire_bytes, ref.raw_bytes)
    assert res.raw_bytes / res.wire_bytes > 3.0
    np.testing.assert_allclose(res.accuracy, ref.accuracy, atol=2.0 / len(data.test_labels))
    np.testing.assert_allclose(res.train_loss, ref.train_loss, rtol=1e-3)
    if codec == "topk":
        assert sorted(eng.executor.residuals) == sorted(
            np.flatnonzero(res.selected_history.any(0)).tolist())
    # The snapshot's wire-byte counters, each package reading the other's.
    for mine, theirs, reader in ((str(tmp_path), ref, jckpt), (ref_ck, ref, tckpt)):
        meta = reader.read_federated_meta(mine)
        assert (meta["wire_bytes"], meta["raw_bytes"]) == (theirs.wire_bytes, theirs.raw_bytes)


def test_codec_schedule_refusals_and_fallback():
    fed = FedConfig(**FED_KW)
    data = make_vision_data(fed, **DATA_KW)
    model = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8, image_size=8))
    spec = lambda **kw: FederatedSpec(model, fed, data, device="cpu", **kw)
    with pytest.raises(ExecutorCompatError, match="sequential executor"):
        spec(compression="topk", executor="batched").build()
    with pytest.warns(UserWarning, match="falling back to the sequential"):
        eng = spec(compression="topk").build()
    assert eng.executor.kind == "sequential" and eng.executor.codec == "topk"
    with pytest.raises(ExecutorCompatError, match="client_chunk"):
        FederatedSpec(model, dataclasses.replace(fed, client_chunk=2), data, device="cpu",
                      compression="int8", executor="batched").build()
    with pytest.raises(ValueError, match="unknown compression codec"):
        spec(compression="fp4").build()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert spec(compression="int8").build().executor.kind == "batched"


@pytest.mark.parametrize("cell", ["async-flat", "sync-hierarchical"])
def test_wire_bytes_in_the_other_engines_and_across_resume(cell, tmp_path):
    """int8 over the async and the hierarchical engines counts every upload,
    and a run killed after round 0 and resumed reports the uninterrupted
    run's counters and params bitwise."""
    fed = FedConfig(**{**FED_KW, "rounds": 3})
    data = make_vision_data(fed, **DATA_KW)
    model = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8, image_size=8))
    kw = dict(selector="heterosel", steps_per_round=1, compression="int8", device="cpu")
    if cell == "async-flat":
        fed = dataclasses.replace(fed, round_policy="async")
        kw["async_cfg"] = AsyncConfig(deadline=1.5, over_select_frac=0.5)
        kw["system"] = np.asarray([1.0, 3.0, 0.5, 2.5, 1.0, 4.0])
    else:
        fed = dataclasses.replace(fed, topology="hierarchical", edge_count=2)
        kw["hier_cfg"] = HierarchyConfig()
    whole = FederatedSpec(model, fed, data, **kw).build().run()
    assert whole.wire_bytes > 0 and whole.raw_bytes > 3 * whole.wire_bytes
    ck = str(tmp_path)
    with pytest.raises(SimulatedPreemption):
        FederatedSpec(model, fed, data, hooks=[CheckpointHook(ck), KillAtRound(0)],
                      **kw).build().run()
    resumed = FederatedSpec(model, fed, data, hooks=[CheckpointHook(ck)], **kw).build().run()
    assert (resumed.wire_bytes, resumed.raw_bytes) == (whole.wire_bytes, whole.raw_bytes)
    np.testing.assert_array_equal(resumed.selected_history, whole.selected_history)
    for k, p in whole.params.items():
        assert torch.equal(resumed.params[k], p), k


def test_run_federated_takes_compression():
    fed = FedConfig(**FED_KW)
    data = make_vision_data(fed, **DATA_KW)
    model = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8, image_size=8))
    res = run_federated(model, fed, data, steps_per_round=1, compression="topk",
                        topk_frac=0.2, client_execution="sequential", device="cpu")
    assert 0 < res.wire_bytes < res.raw_bytes
    assert comp.CompressedExecutor is CompressedExecutor
