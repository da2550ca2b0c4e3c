"""The telemetry plane of the port (``repro_torch.obs``) against the JAX
reference (``repro.obs``): the trace recorder and its validator, the
fairness metrics, ``MetricsRegistry`` rows, ``StabilityReport``, the
matrix aggregator, and ``TelemetryHook`` on a smoke federation, bitwise
non-perturbing and seamless across a kill and a resume.

One reference federation is computed once for the module and carries the
slice's engine paths together: sync and flat, K = 6, 2 rounds of one local
step at lr 0.05, the ``filtered`` selector, the ``drift`` scenario (lazy
drifting data, period 1, and its ``LabelDriftHook``), int8 compression over
the sequential executor and the ``TelemetryHook``. The port runs it on the
reference's initial params and draws (the base's Gumbel row and the pool's
``gumbel(fold_in(key, 1))``). (The lazy data's stacked path, which the
batched executor takes, draws the cohort's batches in another order than
the sequential executor's per-client draws, so both packages run the same
executor; int8 over the batched executor is held to the per-client codec
bitwise in ``test_torch_compression.py``.) Tolerances: histories and
``wire_bytes``/``raw_bytes`` equal; trace events equal in name, phase,
track, category, args and order (wall timestamps aside; the sim timeline's
are virtual time and equal too); registry rows equal in every count, byte
and fairness field, score components within 1e-5, accuracy within
2/N_test and train loss rtol 1e-3 (the bound of ``test_torch_slice.py``);
``StabilityReport`` equal to ``FLResult.summary()`` exactly.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.base import FedConfig as JaxFedConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_variant as jax_smoke_variant
from repro.fed import FederatedSpec as JaxSpec
from repro.fed import make_scenario as jax_make_scenario
from repro.models import build_model as jax_build_model
from repro import obs as jobs
from repro.obs.hook import TelemetryHook as JaxTelemetryHook
from repro_torch import obs
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.data import make_vision_data
from repro_torch.fed import (AsyncConfig, CheckpointHook, FederatedSpec, HierarchyConfig,
                             KillAtRound, MetricsHook, SimulatedPreemption, VerboseHook,
                             make_scenario)
from repro_torch.models import build_model
from repro_torch.obs import (MetricsRegistry, StabilityReport, TelemetryHook, load_jsonl,
                             validate_trace_events)
from repro_torch.obs.trace import NULL_TRACER, PID_SIM, PID_WALL, TraceRecorder
from test_torch_scenarios import filtered_draws
from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROUNDS = 2
FED_KW = dict(num_clients=6, participation=0.5, rounds=ROUNDS, local_epochs=1,
              local_batch=8, lr=0.05, mu=0.1, dirichlet_alpha=0.1, seed=0)
DATA_KW = dict(train_per_class=24, test_per_class=8, noise=0.3, image_size=8)
STEPS = 1
DRIFT = dict(drift_period=1, seed=0)
LAZY = dict(image_size=8, test_per_class=8)


def smoke_model():
    return build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8, image_size=8))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run and the port's, each with a TelemetryHook (the
    port's writes its artifacts): ``{"ref": (res, hook, scenario),
    "port": (res, hook, dir, scenario)}``."""
    jfed, fed = JaxFedConfig(**FED_KW), FedConfig(**FED_KW)
    jmodel = jax_build_model(dataclasses.replace(
        jax_smoke_variant(jax_get_config("resnet18-cifar10")), d_model=8, image_size=8))
    jb = jax_make_scenario("drift", **DRIFT).build(jfed, data_kwargs=LAZY)
    jhook = JaxTelemetryHook()
    ref = JaxSpec(jmodel, jfed, jb.data, selector="filtered", steps_per_round=STEPS,
                  compression="int8", executor="sequential",
                  hooks=[jhook, *jb.hooks]).build().run()
    params = params_from_jax(jax.tree.map(
        np.array, jmodel.init_params(jax.random.PRNGKey(fed.seed + 1))))
    key, noise = jax.random.PRNGKey(fed.seed), []
    for _ in range(ROUNDS):
        key, sk = jax.random.split(key)
        noise.append(filtered_draws(sk, fed.num_clients))
    tb = make_scenario("drift", **DRIFT).build(fed, data_kwargs=LAZY)
    td = str(tmp_path_factory.mktemp("obs") / "run")
    hook = TelemetryHook(trace_dir=td)
    res = FederatedSpec(smoke_model(), fed, tb.data, selector="filtered",
                        steps_per_round=STEPS, compression="int8", executor="sequential",
                        hooks=[hook, *tb.hooks], device="cpu", init_params=params,
                        noise=lambda t, k: noise[t]).build().run()
    return {"ref": (ref, jhook, jb), "port": (res, hook, td, tb)}


def shape(events):
    """Each event without its wall timestamps: (name, phase, track, cat,
    args), with the track named through the metadata events; the sim
    timeline keeps its (virtual) timestamps and durations."""
    tracks = {(e["pid"], e["tid"]): e["args"]["name"] for e in events
              if e["ph"] == "M" and e["name"] == "thread_name"}
    out = []
    for e in events:
        row = (e["name"], e["ph"], e["pid"], tracks.get((e["pid"], e["tid"])),
               e.get("cat"), json.dumps(e.get("args"), sort_keys=True))
        if e["pid"] == PID_SIM:
            row += (e["ts"], e.get("dur"))
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# The recorder, the validator, the fairness metrics
# ---------------------------------------------------------------------------


def record(mod, path):
    """One scripted sequence of recorder calls at fixed clock readings."""
    rec = mod.TraceRecorder(path, epoch=0.0)
    rec.wall_span("select", 1.0, 1.5, args={"round": 0})
    rec.wall_span("execute", 1.5, 1.25, args={"round": 0, "cohort": 3})  # t1 < t0
    rec.sim_span("round", 0.0, 1.0, track="rounds", args={"round": 0})
    rec.instant("completion", 0.75, track="completions", args={"client": 4})
    rec.wall_span("checkpoint_save", 2.0, 2.5, track="checkpoint", cat="ckpt")
    rec.rebase_wall(5e6)
    rec.sim_span("round", 1.0, 0.5)  # negative duration clamps to 0
    rec.flush()
    rec.close()
    return rec


def test_trace_recorder_matches_reference(tmp_path):
    """The same calls give the same events bitwise (the epoch fixed at 0),
    the JSONL stream replays them, and both exports are the same JSON."""
    a = record(jobs.trace, str(tmp_path / "ref.jsonl"))
    b = record(obs.trace, str(tmp_path / "port.jsonl"))
    assert b.events[:-1] == a.events[:-1]
    # After rebase_wall the epoch depends on the call's perf_counter; only
    # the sim event follows, which does not read it.
    assert b.events[-1] == a.events[-1]
    assert b.wall_cursor == a.wall_cursor == 5e6
    assert load_jsonl(str(tmp_path / "port.jsonl")) == b.events
    assert obs.load_jsonl(str(tmp_path / "ref.jsonl")) == jobs.load_jsonl(
        str(tmp_path / "ref.jsonl"))
    with open(a.export_chrome(str(tmp_path / "ref.json"))) as f:
        want = json.load(f)
    with open(b.export_chrome(str(tmp_path / "port.json"))) as f:
        assert json.load(f) == want
    assert not NULL_TRACER.enabled and NULL_TRACER.wall_span("x", 0, 1) is None


_B = {"name": "a", "ph": "B", "ts": 0.0, "pid": 1, "tid": 1}
_E = {"name": "a", "ph": "E", "ts": 1.0, "pid": 1, "tid": 1}
TRACES = {
    "empty": [],
    "b-without-e": [_B],
    "e-without-b": [_E],
    "mis-nested": [_B, dict(_E, name="b")],
    "non-monotone": [_B, _E, dict(_B, ts=0.5), dict(_E, ts=0.6)],
    "negative-dur": [{"name": "x", "ph": "X", "ts": 0.0, "dur": -1.0, "pid": 2, "tid": 1}],
    "x-without-dur": [{"name": "x", "ph": "X", "ts": 0.0, "pid": 2, "tid": 1}],
    "unknown-phase": [dict(_B, ph="Q"), _E],
    "lacks-name": [{"ph": "B", "ts": 0.0, "pid": 1, "tid": 1}],
    "not-a-dict": [["B"]],
    "ok": [_B, dict(_B, name="c", ts=0.2), dict(_E, name="c", ts=0.3), _E,
           {"name": "i", "ph": "i", "ts": 0.1, "pid": 2, "tid": 1, "s": "t"},
           {"name": "m", "ph": "M", "ts": 9.0, "pid": 1, "tid": 0}],
    "other-track-earlier": [_B, _E, dict(_B, tid=2, ts=-5.0), dict(_E, tid=2, ts=-4.0)],
}


def test_validator_refuses_what_the_reference_refuses():
    def verdict(fn, events):
        try:
            fn(events)
        except ValueError as e:
            return str(e)
        return None

    for case, events in TRACES.items():
        want = verdict(jobs.validate_trace_events, events)
        assert verdict(validate_trace_events, events) == want, case
        assert (want is None) == case.startswith(("ok", "other")), case


def test_fairness_metrics_match_reference():
    rng = np.random.default_rng(0)
    cases = [[], [0, 0], [5], [5, 5, 5, 5], [0] * 7 + [7]]
    cases += [rng.integers(0, 9, size=n).tolist() for n in (2, 6, 40, 1000)]
    for c in cases:
        assert obs.gini(c) == jobs.gini(c), c
        assert obs.selection_entropy(c) == jobs.selection_entropy(c), c


def test_matrix_matches_reference(tmp_path):
    """``cell_support`` over the whole grid, and a ``MatrixReport`` folded
    from the same summaries: JSON, markdown, ranking and coverage equal."""
    assert obs.REGIMES == jobs.REGIMES
    assert obs.MATRIX_SCENARIOS == jobs.MATRIX_SCENARIOS
    selectors = ("heterosel", "filtered", "adaptive", "oort")
    rng = np.random.default_rng(1)
    a, b = jobs.MatrixReport(), obs.MatrixReport()
    for s in selectors:
        for r in obs.REGIMES:
            for sc in obs.MATRIX_SCENARIOS:
                why = obs.cell_support(s, r, sc)
                assert why == jobs.cell_support(s, r, sc)
                if why:
                    a.add_unsupported(s, r, sc, why)
                    b.add_unsupported(s, r, sc, why)
                    continue
                curve = rng.uniform(0.1, 0.9, 5).tolist()
                hist = rng.uniform(size=(5, 8)) < 0.5
                for mod, rep in ((jobs, a), (obs, b)):
                    rep.add_run(s, r, sc, mod.StabilityReport(
                        "accuracy", curve, [mod.gini(c) for c in np.cumsum(hist, 0)],
                        [mod.selection_entropy(c) for c in np.cumsum(hist, 0)],
                        hist.sum(0).tolist()))
    assert b.to_json() == a.to_json()
    assert b.to_markdown() == a.to_markdown()
    assert [c.key() for c in b.ranked(scenario="drift")] == [
        c.key() for c in a.ranked(scenario="drift")]
    assert b.missing(selectors + ("random",), obs.REGIMES, obs.MATRIX_SCENARIOS) == a.missing(
        selectors + ("random",), jobs.REGIMES, jobs.MATRIX_SCENARIOS)
    with pytest.raises(ValueError, match="duplicate"):
        b.add_unsupported("heterosel", "sync", "baseline", "again")
    with pytest.raises(ValueError, match="reason"):
        b.add_unsupported("random", "sync", "baseline", "")
    md, js = b.write(str(tmp_path))
    assert json.load(open(js)) == a.to_json() and open(md).read() == a.to_markdown()


# ---------------------------------------------------------------------------
# TelemetryHook on the smoke federation vs the reference
# ---------------------------------------------------------------------------


def test_federation_matches_reference(runs):
    """The filtered selector under drift with int8 compression: the same
    cohorts, bytes on the wire and drift clock as the reference's."""
    ref, _, jb = runs["ref"]
    res, _, _, tb = runs["port"]
    np.testing.assert_array_equal(res.selected_history, np.asarray(ref.selected_history))
    np.testing.assert_allclose(res.accuracy, ref.accuracy,
                               atol=2.0 / len(tb.data.test_labels))
    np.testing.assert_allclose(res.train_loss, ref.train_loss, rtol=1e-3)
    assert (res.wire_bytes, res.raw_bytes) == (ref.wire_bytes, ref.raw_bytes)
    assert 0 < res.wire_bytes < res.raw_bytes
    assert tb.data.current_shift() == jb.data.current_shift() == (ROUNDS - 1) * 3 % 10


def test_trace_events_match_reference(runs):
    _, jhook, _ = runs["ref"]
    _, hook, _, _ = runs["port"]
    validate_trace_events(hook.recorder.events)
    assert shape(hook.recorder.events) == shape(jhook.recorder.events)
    walls = [e["name"] for e in hook.recorder.events if e["ph"] == "B"]
    for phase in ("select", "execute", "aggregate", "eval"):
        assert walls.count(phase) == ROUNDS, phase


EXACT = ("round", "sim_time", "n_selected", "n_arrivals", "n_stragglers", "part_gini",
         "sel_entropy", "staleness_mean", "bytes_down", "bytes_up_edge", "bytes_up_wan",
         "wire_bytes")


def test_registry_rows_match_reference(runs):
    _, jhook, _ = runs["ref"]
    res, hook, _, tb = runs["port"]
    data = tb.data
    rows, want = hook.registry.rounds, jhook.registry.rounds
    assert [sorted(r) for r in rows] == [sorted(r) for r in want]
    for r, w in zip(rows, want):
        for k in EXACT:
            assert r[k] == w[k], (r["round"], k)
        assert abs(r["metric"] - w["metric"]) <= 2.0 / len(data.test_labels)
        assert r["train_loss"] == pytest.approx(w["train_loss"], rel=1e-3)
        for k in (k for k in w if k.startswith("score_")):
            assert r[k] == pytest.approx(w[k], abs=1e-5), (r["round"], k)
        for k in ("select_ms", "execute_ms", "aggregate_ms"):
            assert r[k] > 0.0
    assert hook.registry.counters == jhook.registry.counters
    assert hook.registry.gauges == jhook.registry.gauges
    np.testing.assert_array_equal(hook.registry.selection_counts, res.selection_counts)


def test_stability_report_equals_summary_exactly(runs):
    res, hook, _, _ = runs["port"]
    rep, s = StabilityReport.from_result(res), res.summary()
    assert (rep.peak, rep.final, rep.stable, rep.stability_drop) == (
        s["peak_acc"], s["final_acc"], s["stable_acc"], s["stability_drop"])
    online = StabilityReport.from_registry(hook.registry, res.metric_name)
    assert online.summary() == rep.summary()
    assert online.selection_counts == rep.selection_counts
    # The same arrays through the reference's report: every field equal.
    want = jobs.StabilityReport.from_result(res)
    assert dataclasses.asdict(rep) == dataclasses.asdict(want)
    assert rep.to_markdown() == want.to_markdown()
    assert res.telemetry["stability"] == rep.summary()


def test_artifacts_written(runs):
    res, hook, td, _ = runs["port"]
    md, js = hook.report_paths
    assert (md, js) == (f"{td}/report.md", f"{td}/report.json")
    payload = json.load(open(js))
    assert payload["peak"] == res.summary()["peak_acc"]
    assert payload["stability_drop"] == res.summary()["stability_drop"]
    assert "| stability drop (peak − final) |" in open(md).read()
    events = load_jsonl(f"{td}/trace.jsonl")
    assert events == hook.recorder.events
    assert json.load(open(f"{td}/trace.json"))["traceEvents"] == events
    assert {e["pid"] for e in events} == {PID_WALL, PID_SIM}
    assert res.telemetry["trace_json"] == f"{td}/trace.json"
    assert [r["round"] for r in res.telemetry["registry"]["rounds"]] == list(range(ROUNDS))


# ---------------------------------------------------------------------------
# Port only: non-perturbation, resume, the registry's consumers
# ---------------------------------------------------------------------------


def make_spec_factory(policy, topology, rounds=ROUNDS):
    """A ``make_spec(hooks, **over)`` for one policy × topology cell of the
    reference's telemetry matrix (``tests/test_observability.py``)."""
    fed = FedConfig(**{**FED_KW, "rounds": rounds})
    data = make_vision_data(fed, **DATA_KW)
    kw = dict(selector="heterosel", steps_per_round=STEPS, device="cpu")
    if topology == "hierarchical":
        fed = dataclasses.replace(fed, topology="hierarchical", edge_count=3)
        kw["hier_cfg"] = HierarchyConfig(edges_per_round=2)
    if policy == "async":
        fed = dataclasses.replace(fed, round_policy="async")
        kw["system"] = np.asarray([1.0, 3.0, 0.5, 2.5, 1.0, 4.0])
        kw["async_cfg"] = AsyncConfig(deadline=1.5, over_select_frac=0.5, jitter=0.1)
    model = smoke_model()

    def make_spec(hooks, **over):
        return FederatedSpec(model, fed, data, hooks=list(hooks), **{**kw, **over})

    return make_spec


@pytest.mark.parametrize("policy,topology", [(p, t) for p in ("sync", "async")
                                             for t in ("flat", "hierarchical")])
def test_telemetry_leaves_training_bitwise_unchanged(policy, topology):
    """The reference's golden matrix: histories, metrics, the clock and
    upload series and every parameter bit equal with and without the hook."""
    make_spec = make_spec_factory(policy, topology)
    bare_eng = make_spec([]).build()
    assert bare_eng.tracer is NULL_TRACER
    bare = bare_eng.run()
    hook = TelemetryHook()
    wired = make_spec([hook]).build().run()
    np.testing.assert_array_equal(wired.selected_history, bare.selected_history)
    np.testing.assert_array_equal(wired.accuracy, bare.accuracy)
    np.testing.assert_array_equal(wired.train_loss, bare.train_loss)
    for name in ("wall_clock", "round_staleness", "cloud_uploads"):
        a, b = getattr(bare, name), getattr(wired, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for k, p in bare.params.items():
        assert torch.equal(p.view(torch.uint8), wired.params[k].view(torch.uint8)), k
    validate_trace_events(hook.recorder.events)
    assert [r["round"] for r in hook.registry.rounds] == list(range(ROUNDS))
    assert wired.telemetry["stability"]["rounds"] == ROUNDS
    names = {e["name"] for e in hook.recorder.events if e["ph"] != "M"}
    want = {"execute", "aggregate", "eval", "round"}
    want |= ({"outer_select", "inner_select", "edge_execute"}
             if topology == "hierarchical" else {"select"})
    assert want <= names
    if policy == "async":
        assert "completion" in names


def test_killed_and_resumed_telemetry_is_seamless(tmp_path):
    """The hook's registry and sim cursor ride the checkpoint and the JSONL
    stream appends: one gap-free trace and one registry row per round."""
    make_spec = make_spec_factory("async", "flat", rounds=4)
    td, ck = str(tmp_path / "trace"), str(tmp_path / "ck")
    with pytest.raises(SimulatedPreemption):
        make_spec([TelemetryHook(trace_dir=td), CheckpointHook(ck, every=1),
                   KillAtRound(1)]).build().run()
    hook = TelemetryHook(trace_dir=td)
    res = make_spec([hook, CheckpointHook(ck, every=1)]).build().run()
    rows = hook.registry.rounds
    assert [r["round"] for r in rows] == list(range(4))
    assert all(r["select_ms"] > 0.0 for r in rows)
    np.testing.assert_array_equal(hook.registry.selection_counts,
                                  res.selected_history.astype(np.int64).sum(0))
    events = load_jsonl(f"{td}/trace.jsonl")
    validate_trace_events(events)
    sims = [e for e in events if e["pid"] == PID_SIM and e["ph"] == "X"]
    assert [e["args"]["round"] for e in sims] == list(range(4))
    assert json.load(open(f"{td}/trace.json"))["traceEvents"] == events
    assert sum(e["name"] == "checkpoint_save" for e in events if e["ph"] == "B") == 4
    # The uninterrupted run gives the same per-round fields.
    whole = TelemetryHook()
    make_spec([whole]).build().run()
    for r, w in zip(rows, whole.registry.rounds):
        assert {k: v for k, v in r.items() if not k.endswith("_ms")} == {
            k: v for k, v in w.items() if not k.endswith("_ms")}


def test_verbose_hook_renders_from_the_shared_registry(capsys):
    """``VerboseHook`` prints the reference's line from the registry, shared
    with a ``TelemetryHook`` (one row per round for both); hooks run in
    priority order after the pinned ``MetricsHook``; 'telemetry' is a
    registry name."""
    make_spec = make_spec_factory("sync", "flat", rounds=2)
    eng = make_spec(["verbose", "telemetry"]).build()
    assert [type(h) for h in eng.hooks] == [MetricsHook, TelemetryHook, VerboseHook]
    res = eng.run()
    verbose, tel = eng.hooks[2], eng.hooks[1]
    assert verbose.registry is tel.registry
    assert [r["round"] for r in tel.registry.rounds] == [0, 1]
    out = capsys.readouterr().out
    for t in (0, 1):
        row = tel.registry.rounds[t]
        assert jobs.MetricsRegistry().format_round(
            row, selector="heterosel", metric_name="accuracy") in out
        assert (f"[heterosel] round {t:3d}  accuracy={res.accuracy[t]:.4f}  "
                f"loss={res.train_loss[t]:.4f}") in out
    alone = make_spec([VerboseHook()]).build()
    alone.run()
    assert isinstance(alone.hooks[1].registry, MetricsRegistry)
    assert alone.hooks[1].registry.rounds[0]["bytes_up_wan"] > 0
