"""The port's kill-and-resume matrix (torch only, no JAX).

Every ``round_policy × topology`` cell, with and without the bf16
``compact_state`` layout, runs uninterrupted, then killed by
``KillAtRound(1)`` behind a ``CheckpointHook`` and resumed from its
directory, once for each kill phase (after round 1's hooks, and at the
start of round 2). The resumed run must equal the uninterrupted one
bitwise: selection history, metric and train-loss series, ``wall_clock``,
``round_staleness``, ``cloud_uploads`` and every parameter's bytes. The
runs take their draws from the engine's default generators, so the
snapshot's generator states are what keeps the draws in step.

The async cells use the reference matrix's hostile profile
(``tests/test_resume_matrix.py:53-73``: multipliers [1, 3, .5, 2.5, 1, 4],
deadline 1.5, ε 0.5, jitter 0.1), so the snapshot holds in-flight
completions. The adaptive selectors' cells (the edge-budget controller and
``AdaptiveMuHook``'s state ride the snapshot) and an availability trace
are cases of one test in ``test_torch_resume_cells.py``; here, as cases of
one test, the loud cases of ``test_resume_matrix.py:167-264`` (engine kind, compact
flip, edge count, ``keep_last``, corrupt latest, all corrupt).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import (CheckpointMismatchError, list_federated_rounds,
                              read_federated_meta)
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.core.state import field_dtypes
from repro_torch.data import make_vision_data
from repro_torch.fed import (AsyncConfig, CheckpointHook, FederatedSpec, HierarchyConfig,
                             KillAtRound, SimulatedPreemption)
from repro_torch.models import build_model


ROUNDS = 4
KILL_AT = 1  # the snapshot covers rounds 0..1: resume from round 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    model = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8))
    fed = FedConfig(num_clients=6, participation=0.5, rounds=ROUNDS, local_epochs=1,
                    local_batch=8, lr=0.2, mu=0.1, dirichlet_alpha=0.1, seed=0)
    data = make_vision_data(fed, train_per_class=24, test_per_class=8, noise=0.3)
    return fed, data, model


def make_spec_factory(setup, policy, topology, compact, selector="heterosel", **extra):
    """A ``make_spec(hooks)`` for one matrix cell."""
    fed, data, model = setup
    kw = dict(selector=selector, steps_per_round=2, compact_state=compact, device="cpu",
              **extra)
    if topology == "hierarchical":
        fed = dataclasses.replace(fed, topology="hierarchical", edge_count=3)
        kw["hier_cfg"] = HierarchyConfig(edges_per_round=2)
    if policy == "async":
        fed = dataclasses.replace(fed, round_policy="async")
        kw["system"] = np.asarray([1.0, 3.0, 0.5, 2.5, 1.0, 4.0])
        kw["async_cfg"] = AsyncConfig(deadline=1.5, over_select_frac=0.5, jitter=0.1)

    def make_spec(hooks):
        return FederatedSpec(model, fed, data, hooks=list(hooks), **kw)

    return make_spec


def kill_and_resume(make_spec, ckdir, phase, extra_hooks=lambda: []):
    with pytest.raises(SimulatedPreemption):
        make_spec(extra_hooks() + [CheckpointHook(ckdir), KillAtRound(KILL_AT, phase=phase)]
                  ).build().run()
    engine = make_spec(extra_hooks() + [CheckpointHook(ckdir)]).build()
    return engine.run(), engine


def bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().view(np.uint8)


def assert_bitwise_resume(full, resumed, engine, *, compact):
    assert engine.start_round == KILL_AT + 1
    np.testing.assert_array_equal(resumed.selected_history, full.selected_history)
    for name in ("accuracy", "train_loss", "wall_clock", "round_staleness",
                 "cloud_uploads", "mu_history"):
        a, b = getattr(full, name), getattr(resumed, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                          np.asarray(b).view(np.uint8), err_msg=name)
    assert list(full.params) == list(resumed.params)
    for k in full.params:
        assert full.params[k].dtype == resumed.params[k].dtype, k
        np.testing.assert_array_equal(bits(full.params[k]), bits(resumed.params[k]),
                                      err_msg=k)
    layout = field_dtypes(engine.state)
    assert layout["last_selected"] == torch.int32
    assert layout["loss_prev"] == (torch.bfloat16 if compact else torch.float32)


MATRIX = [(p, t) for p in ("sync", "async") for t in ("flat", "hierarchical")]


@pytest.mark.parametrize("policy,topology", MATRIX)
@pytest.mark.parametrize("compact", [False, True], ids=["f32state", "compact"])
def test_kill_at_round_t_resumes_bitwise(setup, tmp_path, policy, topology, compact):
    make_spec = make_spec_factory(setup, policy, topology, compact)
    full = make_spec([]).build().run()
    for phase in KillAtRound.PHASES:
        ckdir = str(tmp_path / phase)
        resumed, engine = kill_and_resume(make_spec, ckdir, phase)
        assert_bitwise_resume(full, resumed, engine, compact=compact)
        if policy == "async":
            events = [read_federated_meta(ckdir, r)["extra"]["clock"]["events"]
                      for r in list_federated_rounds(ckdir)]
            assert any(events), "no snapshot held an in-flight completion"


# (selector, policy, topology, extra spec fields, extra hooks)


# ---------------------------------------------------------------------------
# Loud cases
# ---------------------------------------------------------------------------


def _kill(make_spec, ckdir, t=KILL_AT, **hook_kw):
    with pytest.raises(SimulatedPreemption):
        make_spec([CheckpointHook(ckdir, **hook_kw), KillAtRound(t)]).build().run()


def case_engine_kind(setup, ckdir):
    _kill(make_spec_factory(setup, "sync", "flat", False), ckdir)
    with pytest.raises(CheckpointMismatchError, match="sync/flat"):
        make_spec_factory(setup, "async", "flat", False)([CheckpointHook(ckdir)]
                                                         ).build().run()


def case_compact_flip(setup, ckdir):
    _kill(make_spec_factory(setup, "sync", "flat", True), ckdir)
    with pytest.raises(CheckpointMismatchError, match="dtype"):
        make_spec_factory(setup, "sync", "flat", False)([CheckpointHook(ckdir)]
                                                        ).build().run()


def case_edge_count(setup, ckdir):
    fed, data, model = setup
    hfed = dataclasses.replace(fed, topology="hierarchical", edge_count=3)
    kw = dict(selector="heterosel", steps_per_round=2, device="cpu")
    with pytest.raises(SimulatedPreemption):
        FederatedSpec(model, hfed, data, hooks=[CheckpointHook(ckdir), KillAtRound(KILL_AT)],
                      **kw).build().run()
    with pytest.raises(CheckpointMismatchError, match="edge_count"):
        FederatedSpec(model, dataclasses.replace(hfed, edge_count=2), data,
                      hooks=[CheckpointHook(ckdir)], **kw).build().run()


def case_keep_last(setup, ckdir):
    make_spec = make_spec_factory(setup, "sync", "flat", False)
    full = make_spec([]).build().run()
    _kill(make_spec, ckdir, t=2, keep_last=2)
    assert list_federated_rounds(ckdir) == [2, 3]  # exactly N remain
    engine = make_spec([CheckpointHook(ckdir, keep_last=2)]).build()
    resumed = engine.run()
    assert engine.start_round == 3
    np.testing.assert_array_equal(resumed.selected_history, full.selected_history)
    np.testing.assert_array_equal(resumed.accuracy, full.accuracy)
    with pytest.raises(ValueError, match="keep_last"):
        CheckpointHook(ckdir, keep_last=0)


def case_corrupt_latest(setup, ckdir):
    make_spec = make_spec_factory(setup, "sync", "flat", False)
    full = make_spec([]).build().run()
    _kill(make_spec, ckdir, t=2)
    assert list_federated_rounds(ckdir) == [1, 2, 3]
    with open(os.path.join(ckdir, "fedround_00000003.npz"), "r+b") as f:
        f.truncate(100)   # a write cut by the preemption
    engine = make_spec([CheckpointHook(ckdir)]).build()
    with pytest.warns(RuntimeWarning, match="skipping unreadable"):
        resumed = engine.run()
    assert engine.start_round == 2
    np.testing.assert_array_equal(resumed.selected_history, full.selected_history)
    np.testing.assert_array_equal(resumed.accuracy, full.accuracy)


def case_all_corrupt(setup, ckdir):
    make_spec = make_spec_factory(setup, "sync", "flat", False)
    _kill(make_spec, ckdir)
    for r in list_federated_rounds(ckdir):
        with open(os.path.join(ckdir, f"fedround_{r:08d}.npz"), "r+b") as f:
            f.truncate(10)
    with pytest.raises(RuntimeError, match="no readable snapshot"):
        make_spec([CheckpointHook(ckdir)]).build().run()


LOUD = {"engine kind": case_engine_kind, "compact flip": case_compact_flip,
        "edge count": case_edge_count, "keep_last": case_keep_last,
        "corrupt latest": case_corrupt_latest, "all corrupt": case_all_corrupt}


@pytest.mark.parametrize("case", list(LOUD))
def test_resume_refusals_and_fallbacks(setup, tmp_path, case):
    LOUD[case](setup, str(tmp_path / "ck"))


def test_kill_at_round_validates_phase():
    with pytest.raises(ValueError, match="phase"):
        KillAtRound(2, phase="mid_gradient")


def test_hooks_by_registry_name(setup):
    fed, data, model = setup
    fed = dataclasses.replace(fed, rounds=2)
    res = FederatedSpec(model, fed, data, selector="heterosel", steps_per_round=1,
                        device="cpu", hooks=["adaptive_mu"]).build().run()
    assert res.mu_history is not None and len(res.mu_history) == 2
    eng = FederatedSpec(model, fed, data, device="cpu", hooks=["telemetry"]).build()
    assert type(eng.hooks[1]).__name__ == "TelemetryHook"
    with pytest.raises(ValueError, match="unknown hook"):
        FederatedSpec(model, fed, data, device="cpu", hooks=["nope"]).build()
