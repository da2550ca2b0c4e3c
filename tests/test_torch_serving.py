"""The serving tier of the port (``repro_torch.serve``, ``launch.serve``)
against the reference's (``repro.serve``), and the reference's serving
contracts (``tests/test_serving.py``) mirrored on the port.

Model: the reference tests' ``tiny_lm_cfg`` (qwen2 smoke variant, d_model
32, d_ff 64, vocab 64, 2 heads of 16), its weights the reference's
``init_params(PRNGKey(0))`` carried with ``repro_torch.convert``. Random
draws come from outside: each request's sampling source replays the
reference's own Gumbel rows (``jax_rows``: per token ``key, sk =
split(key)``, then ``gumbel(sk, (1, vocab), f32)``, the key the reference's
traffic gives request ``rid``), which is what the reference's
``categorical`` adds to the logits (``test_categorical_is_gumbel_argmax``).

Tolerances:
  * tokens bitwise equal (served and offline, port and reference), in f32
    (``DEFAULT_DTYPE`` and the KV cache's dtype patched to float32 in both
    packages' dense and attention modules, so neither rounds a logit to
    bf16 that the other does not); the logits they come from agree to ~1e-6;
  * the traffic stream (arrival times, prompts, output lengths) bitwise;
  * training with ``PublishHook`` bitwise equal to training without it, in
    each of the four {sync, async} × {flat, hierarchical} cells (the port
    against itself); ``served_metric`` against the reference's in the sync
    flat cell on the reference's draws (initial params and per-round Gumbel
    rows), rtol 1e-3 as ``test_torch_lm_slice.py`` holds exp(-loss)
    (``test_torch_serving_fed.py``);
  * ``resolve_params`` on a directory the reference's ``CheckpointHook``
    wrote: the reference's final params bitwise.
"""

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
from repro.fed import CheckpointHook as JaxCheckpointHook
from repro.fed import FederatedSpec as JaxFederatedSpec
from repro.fed.clock import VirtualClock as JaxVirtualClock
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import dense as jdense
from repro.serve import ModelServer as JaxModelServer
from repro.serve import TrafficConfig as JaxTrafficConfig
from repro.serve import TrafficSimulator as JaxTrafficSimulator
from repro.serve import VersionRegistry as JaxVersionRegistry
from repro.serve import generate as jax_generate
from repro_torch.ckpt import CheckpointMismatchError
from repro_torch.configs import FedConfig, get_config, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.data import make_lm_data, make_vision_data
from repro_torch.fed import (AsyncConfig, CheckpointHook, FederatedSpec, HierarchyConfig,
                             RoundHook)
from repro_torch.fed.clock import VirtualClock
from repro_torch.launch.serve import resolve_params
from repro_torch.models import attention, build_model, dense
from repro_torch.serve import (ModelServer, PublishHook, TrafficConfig, TrafficSimulator,
                               VersionRegistry, generate)
from repro_torch.serve.server import slot_tick
from repro_torch.serve.traffic import GumbelSource, RowSource, request_seed

from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)


TINY = dict(d_model=32, d_ff=64, vocab_size=64, num_heads=2, num_kv_heads=2, head_dim=16,
            name="qwen2-serve-tiny")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files on parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny_cfgs():
    return (dataclasses.replace(jax_smoke_variant(jax_get_config("qwen2-0.5b")), **TINY),
            dataclasses.replace(smoke_variant(get_config("qwen2-0.5b")), **TINY))


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = tiny_cfgs()
    return jax_build_model(jcfg), build_model(cfg)


@pytest.fixture(scope="module")
def lm_params(models):
    """The reference's init in f32, and the same in the port."""
    jm, _ = models
    jp = jax.tree.map(lambda a: np.array(a, np.float32),
                      jax.jit(jm.init_params)(jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp)


@pytest.fixture()
def all_f32(monkeypatch):
    """Activations and KV caches in f32 in both packages."""
    monkeypatch.setattr(jdense, "DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(dense, "DEFAULT_DTYPE", torch.float32)
    monkeypatch.setattr(jattn.init_kv_cache, "__defaults__", (jnp.float32,))
    monkeypatch.setattr(attention.init_kv_cache, "__defaults__", (torch.float32, None))


def jax_rows(key, n: int, vocab: int):
    """The reference's Gumbel rows for ``n`` tokens from a request's key."""
    rows = []
    for _ in range(n):
        key, sk = jax.random.split(key)
        rows.append(np.asarray(jax.random.gumbel(sk, (1, vocab), jnp.float32)))
    return rows


def both_streams(vocab, **kw):
    """The reference's request stream of a config, and the port's carrying
    the reference requests' Gumbel rows."""
    n = kw["max_requests"]
    jreqs = JaxTrafficSimulator(JaxTrafficConfig(**kw), vocab=vocab).take(n)
    reqs = TrafficSimulator(TrafficConfig(**kw), vocab=vocab).take(n)
    return jreqs, [dataclasses.replace(r, draws=RowSource(jax_rows(j.key, j.output_len, vocab)))
                   for r, j in zip(reqs, jreqs)]


# ---------------------------------------------------------------------------
# Sampling: the reference's categorical is Gumbel-max
# ---------------------------------------------------------------------------


def test_categorical_is_gumbel_argmax():
    """jax 0.9.0: ``categorical(sk, l)`` = ``argmax(l + gumbel(sk, l.shape,
    f32))``, the identity the port's sampling rests on."""
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(3)
    for i in range(20):
        logits = jnp.asarray(rng.standard_normal((2, 64)).astype(np.float32) * (i % 4))
        key, sk = jax.random.split(key)
        want = np.asarray(jax.random.categorical(sk, logits))
        got = np.argmax(np.asarray(logits) + np.asarray(jax.random.gumbel(sk, (2, 64),
                                                                          jnp.float32)), -1)
        assert np.array_equal(got, want)


def test_request_seed_and_default_draws():
    """The default source: a documented (seed, rid) mix; each ``stream()``
    starts over; seeds and requests give distinct rows."""
    assert request_seed(0, 0) != request_seed(0, 1) != request_seed(1, 0)
    assert 0 <= request_seed(2 ** 40, 2 ** 33) < 2 ** 63
    src = GumbelSource(request_seed(3, 5))
    a, b = src.stream(), src.stream()
    r1, r2 = a((1, 64), "cpu"), a((1, 64), "cpu")
    assert torch.equal(r1, b((1, 64), "cpu")) and not torch.equal(r1, r2)
    reqs = TrafficSimulator(TrafficConfig(seed=3, max_requests=6), vocab=64).take(6)
    assert reqs[5].draws == src
    with pytest.raises(ValueError, match="asked for"):
        RowSource([np.zeros((1, 4))]).stream()((1, 5), "cpu")


# ---------------------------------------------------------------------------
# Registry invariants
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_versions_dense_and_immutable(self, lm_params):
        _, tp = lm_params
        reg = VersionRegistry()
        assert reg.latest() is None
        v0 = reg.publish(tp, round_idx=-1)
        v1 = reg.publish(tp, round_idx=0, step=4, metric=0.5)
        assert (v0.version, v1.version) == (0, 1)
        assert reg.latest() is v1 and v1.params is tp   # a reference, not a copy
        assert reg.get(0) is v0 and len(reg) == 2 and reg.versions == (v0, v1)
        with pytest.raises(KeyError):
            reg.get(2)
        with pytest.raises(dataclasses.FrozenInstanceError):
            v1.round = 99

    def test_server_refuses_empty_registry(self, models):
        _, tm = models
        srv = ModelServer(tm, VersionRegistry(), batch_width=2, max_len=16, device="cpu")
        srv.submit(TrafficSimulator(TrafficConfig(seed=0, max_requests=1), vocab=64).take(1)[0])
        with pytest.raises(RuntimeError, match="no published version"):
            srv.pump()

    def test_request_too_long_is_loud(self, models, lm_params):
        _, tm = models
        reg = VersionRegistry()
        reg.publish(lm_params[1], round_idx=-1)
        srv = ModelServer(tm, reg, batch_width=1, max_len=4, device="cpu")
        sim = TrafficSimulator(TrafficConfig(prompt_len=(3, 3), output_len=(4, 4), seed=0,
                                             max_requests=1), vocab=64)
        with pytest.raises(ValueError, match="cache positions"):
            srv.submit(sim.take(1)[0])

    def test_vlm_and_non_decoding_models_are_refused(self):
        vlm = build_model(smoke_variant(get_config("llama-3.2-vision-90b")))
        with pytest.raises(NotImplementedError, match="cross-attention"):
            ModelServer(vlm, VersionRegistry(), device="cpu")
        enc = build_model(smoke_variant(get_config("hubert-xlarge")))
        with pytest.raises(ValueError, match="encoder-only"):
            ModelServer(enc, VersionRegistry(), device="cpu")


# ---------------------------------------------------------------------------
# Served outputs ≡ offline decode ≡ the reference's, bitwise
# ---------------------------------------------------------------------------


def test_generate_matches_reference(models, lm_params, all_f32):
    """Batch 2, on the reference's rows: the port's ``generate`` gives the
    reference's tokens, alone and as slot 0 of 3-slot ticks."""
    jm, tm = models
    jp, tp = lm_params
    prompt = np.random.default_rng(1).integers(0, 64, size=(2, 5)).astype(np.int32)
    key = jax.random.PRNGKey(4)
    want = jax_generate(jm, jp, prompt, 6, key)
    rows, k = [], key
    for _ in range(6):
        k, sk = jax.random.split(k)
        rows.append(np.asarray(jax.random.gumbel(sk, (2, 64), jnp.float32)))
    got = generate(tm, tp, prompt, 6, RowSource(rows))
    assert np.array_equal(got, want)
    for b in range(2):
        one = generate(tm, tp, prompt[b:b + 1], 6, RowSource([r[b:b + 1] for r in rows]),
                       slots=3)
        assert np.array_equal(one[0], want[b])


def test_concurrent_requests_match_reference_and_offline(models, lm_params, all_f32):
    """3 slots, 7 requests of different prompt and output lengths: slot
    positions desynchronize (continuous batching), yet every request's tokens
    equal the reference server's, the reference's ``generate`` and the
    port's own ``generate`` (batch 1, and as one slot of 3-slot ticks)."""
    jm, tm = models
    jp, tp = lm_params
    kw = dict(rate=4.0, prompt_len=(1, 5), output_len=(2, 8), seed=7, max_requests=7)
    jreqs, reqs = both_streams(64, **kw)

    jreg = JaxVersionRegistry()
    jreg.publish(jp, round_idx=-1)
    jsrv = JaxModelServer(jm, jreg, batch_width=3, max_len=16)
    reg = VersionRegistry()
    reg.publish(tp, round_idx=-1)
    srv = ModelServer(tm, reg, batch_width=3, max_len=16, device="cpu")
    for jr, r in zip(jreqs, reqs):
        jsrv.submit(jr, arrival_round=0)
        srv.submit(r, arrival_round=0)
    jrecs = {rec.rid: rec for rec in jsrv.pump()}
    recs = {rec.rid: rec for rec in srv.pump()}
    assert len(recs) == 7
    for jr, r in zip(jreqs, reqs):
        want = jrecs[r.rid].tokens
        assert want == tuple(jax_generate(jm, jp, jr.prompt[None, :], jr.output_len,
                                          jr.key)[0].tolist())
        assert recs[r.rid].tokens == want, r.rid
        assert tuple(generate(tm, tp, r.prompt[None], r.output_len, r.draws)[0]) == want
        assert tuple(generate(tm, tp, r.prompt[None], r.output_len, r.draws,
                              slots=3)[0]) == want
        assert recs[r.rid].version == 0 and recs[r.rid].lag_rounds == 1
        for f in ("arrival_time", "prompt_len", "output_len", "version_round"):
            assert getattr(recs[r.rid], f) == getattr(jrecs[r.rid], f), f


def test_tick_logits_equal_batch1_steps_on_the_cpu(models, lm_params):
    """Measured on the CPU (bf16, the default dtypes): a 3-slot tick gives
    every slot the logits bits of a batch-1 step on that slot's cache (the
    card does not: ``chip_smoke.py`` phase 14a)."""
    _, tm = models
    tp = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 and v.dim() > 1 else v
          for k, v in lm_params[1].items()}
    rng = np.random.default_rng(2)
    caches, toks = [], []
    with torch.no_grad():
        for i in range(3):
            cache = tm.init_cache(1, 8, device="cpu")
            for pos in range(i + 1):
                tok = torch.from_numpy(rng.integers(0, 64, size=(1, 1)).astype(np.int32))
                _, cache = tm.decode_step(tp, cache, tok, pos)
            caches.append(cache)
            toks.append(int(rng.integers(0, 64)))
        stacked = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
        logits, _ = slot_tick(tm)(tp, stacked, torch.tensor(toks, dtype=torch.int32)
                                  .reshape(3, 1, 1), torch.tensor([1, 2, 3]))
        for i in range(3):
            one, _ = tm.decode_step(tp, caches[i], torch.tensor([[toks[i]]],
                                                                dtype=torch.int32), i + 1)
            assert torch.equal(logits[i].view(torch.int16), one.view(torch.int16))


# ---------------------------------------------------------------------------
# Hot-swap atomicity
# ---------------------------------------------------------------------------


def _other_params(tm, seed):
    return tm.init_params(torch.Generator().manual_seed(seed))


class TestHotSwap:
    def test_mid_decode_publish_is_atomic(self, models):
        """Publishing v1 while a request decodes on v0 changes no token of
        it; the next admission wave serves v1."""
        _, tm = models
        p1, p2 = _other_params(tm, 1), _other_params(tm, 99)
        r1, r2 = TrafficSimulator(TrafficConfig(prompt_len=(3, 3), output_len=(6, 6), seed=5,
                                                max_requests=2), vocab=64).take(2)
        reg = VersionRegistry()
        reg.publish(p1, round_idx=-1)
        srv = ModelServer(tm, reg, batch_width=2, max_len=16, device="cpu")
        srv.submit(r1, arrival_round=0)
        for _ in range(4):      # mid-flight: prompt consumed, still decoding
            srv.step()
        assert srv.num_active == 1 and srv.serving_version.version == 0
        reg.publish(p2, round_idx=0)           # hot-swap lands here
        (rec1,) = srv.pump()
        srv.submit(r2, arrival_round=1)
        (rec2,) = srv.pump()
        assert rec1.tokens == tuple(generate(tm, p1, r1.prompt[None], 6, r1.draws, slots=2)[0])
        assert rec1.version == 0
        assert rec2.tokens == tuple(generate(tm, p2, r2.prompt[None], 6, r2.draws, slots=2)[0])
        assert rec2.version == 1 and rec2.lag_rounds == 1
        c0 = tm.init_cache(1, 16, device="cpu")
        tok = torch.from_numpy(r1.prompt[None, :1])
        with torch.no_grad():
            l1, _ = tm.decode_step(p1, c0, tok, 0)
            l2, _ = tm.decode_step(p2, c0, tok, 0)
        assert not torch.allclose(l1, l2)

    def test_stale_wave_admission(self, models):
        """A request admitted while an older wave is in flight joins the
        wave's (stale) version — versions never mix mid-wave."""
        _, tm = models
        p1, p2 = _other_params(tm, 1), _other_params(tm, 98)
        r1, r2 = TrafficSimulator(TrafficConfig(prompt_len=(2, 2), output_len=(5, 5), seed=9,
                                                max_requests=2), vocab=64).take(2)
        reg = VersionRegistry()
        reg.publish(p1, round_idx=-1)
        srv = ModelServer(tm, reg, batch_width=2, max_len=16, device="cpu")
        srv.submit(r1)
        srv.step()                       # r1 in flight on v0
        reg.publish(p2, round_idx=0)
        srv.submit(r2)                   # admitted mid-wave → joins v0
        recs = {rec.rid: rec for rec in srv.pump()}
        assert recs[r1.rid].version == 0 and recs[r2.rid].version == 0
        assert recs[r2.rid].tokens == tuple(generate(tm, p1, r2.prompt[None], 5, r2.draws,
                                                     slots=2)[0])

    def test_reused_slot_starts_from_zero_state(self):
        """Recurrent state does not leak into a slot's next occupant: on
        mamba2, 5 requests through 2 slots give what each alone gives."""
        tm = build_model(dataclasses.replace(smoke_variant(get_config("mamba2-370m")),
                                             d_model=64, vocab_size=64))
        p = tm.init_params(torch.Generator().manual_seed(0))
        reg = VersionRegistry()
        reg.publish(p, round_idx=-1)
        srv = ModelServer(tm, reg, batch_width=2, max_len=12, device="cpu")
        reqs = TrafficSimulator(TrafficConfig(prompt_len=(1, 4), output_len=(2, 5), seed=4,
                                              max_requests=5), vocab=64).take(5)
        for r in reqs:
            srv.submit(r)
        recs = {rec.rid: rec for rec in srv.pump()}
        for r in reqs:
            assert recs[r.rid].tokens == tuple(
                generate(tm, p, r.prompt[None], r.output_len, r.draws, slots=2)[0])


# ---------------------------------------------------------------------------
# Seeded traffic determinism
# ---------------------------------------------------------------------------


class TestTrafficDeterminism:
    def test_stream_is_the_references_under_any_windowing(self):
        """The port's stream, drained in ragged windows, equals the
        reference's drained in one (and both their own in one window)."""
        kw = dict(rate=3.0, prompt_len=(1, 6), output_len=(2, 9), seed=42)
        jsim = JaxTrafficSimulator(JaxTrafficConfig(**kw), vocab=64)
        sim = TrafficSimulator(TrafficConfig(**kw), vocab=64)
        jq, q = JaxVirtualClock().channel("serve"), VirtualClock().channel("serve")
        jsim.schedule_until(jq, 10.0)
        for t in (0.3, 0.31, 2.0, 5.5, 10.0):
            sim.schedule_until(q, t)
        jevs, evs = jq.pop_due(10.0), q.pop_due(10.0)
        assert len(jevs) == len(evs) > 10
        for je, e in zip(jevs, evs):
            jr, r = je.payload, e.payload
            assert (r.rid, r.arrival_time, r.output_len) == (jr.rid, jr.arrival_time,
                                                             jr.output_len)
            assert (je.time, je.seq, je.client) == (e.time, e.seq, e.client)
            assert r.prompt.dtype == jr.prompt.dtype and np.array_equal(r.prompt, jr.prompt)
            assert r.draws == GumbelSource(request_seed(42, r.rid))
        # and take() continues the stream where the windows stopped
        assert [r.rid for r in sim.take(2)] == [r.rid for r in jsim.take(2)]

    def test_different_seed_differs(self):
        a = TrafficSimulator(TrafficConfig(seed=0, max_requests=8), vocab=64).take(8)
        b = TrafficSimulator(TrafficConfig(seed=1, max_requests=8), vocab=64).take(8)
        assert [r.arrival_time for r in a] != [r.arrival_time for r in b]
        assert len(a) == 8 and not TrafficSimulator(
            TrafficConfig(seed=0, max_requests=0), vocab=64).take(1)

    def test_serving_is_deterministic_end_to_end(self, models, lm_params):
        _, tm = models
        outs = []
        for _ in range(2):
            reg = VersionRegistry()
            reg.publish(lm_params[1], round_idx=-1)
            srv = ModelServer(tm, reg, batch_width=2, max_len=16, device="cpu")
            for r in TrafficSimulator(TrafficConfig(rate=5.0, seed=11, max_requests=5),
                                      vocab=64).take(5):
                srv.submit(r)
            outs.append([rec.tokens for rec in srv.pump()])
        assert outs[0] == outs[1]

    def test_validation_is_loud(self):
        with pytest.raises(ValueError, match="rate"):
            TrafficConfig(rate=0.0)
        with pytest.raises(ValueError, match="prompt_len"):
            TrafficConfig(prompt_len=(0, 3))
        with pytest.raises(ValueError, match="vocab"):
            TrafficSimulator(TrafficConfig(), vocab=0)


# ---------------------------------------------------------------------------
# Training is bitwise unchanged with the serving tier attached
# ---------------------------------------------------------------------------


FED_KW = dict(num_clients=6, participation=0.5, rounds=3, local_epochs=1, local_batch=4,
              lr=0.3, mu=0.1, seed=0)
CELLS = [("sync", "flat"), ("sync", "hierarchical"), ("async", "flat"),
         ("async", "hierarchical")]
SERVE_KW = dict(rate=3.0, prompt_len=(2, 4), output_len=(3, 5), seed=1)


def lm_fed(**over):
    return FedConfig(**{**FED_KW, **over})


def build_spec(model, data, fed, policy, topology, hooks, **kw):
    return FederatedSpec(model, fed, data, steps_per_round=2, hooks=hooks,
                         round_policy=policy, device="cpu",
                         async_cfg=AsyncConfig(deadline=1.5, over_select_frac=0.5)
                         if policy == "async" else None,
                         hier_cfg=HierarchyConfig() if topology == "hierarchical" else None,
                         **kw)


@pytest.mark.parametrize("policy,topology", CELLS, ids=[f"{p}-{t}" for p, t in CELLS])
def test_training_bitwise_unchanged_with_serving(models, policy, topology):
    """Attaching PublishHook (live traffic, per-round publish, accuracy
    under traffic) moves no bit of training: metrics, selection history,
    wall clock, cloud uploads, final params."""
    _, tm = models
    fed = lm_fed(topology=topology, edge_count=2 if topology == "hierarchical" else 0)
    data = make_lm_data(fed, vocab=tm.cfg.vocab_size, seq_len=8)
    base = build_spec(tm, data, fed, policy, topology, []).build().run()
    hook = PublishHook(traffic=TrafficConfig(**SERVE_KW), batch_width=2, max_len=12)
    served = build_spec(tm, data, fed, policy, topology, [hook]).build().run()

    for name in ("accuracy", "train_loss", "selected_history", "wall_clock",
                 "round_staleness", "cloud_uploads"):
        a, b = getattr(base, name), getattr(served, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), name
    assert sorted(base.params) == sorted(served.params)
    for k, p in base.params.items():
        assert torch.equal(p.view(torch.uint8), served.params[k].view(torch.uint8)), k
    assert base.serving is None and base.served_metric is None

    s = served.serving
    assert s["requests"] > 0 and s["versions_published"] == fed.rounds + 1
    assert s["mean_lag_rounds"] >= 1.0 and s["latest_version"] == fed.rounds
    assert served.served_metric.shape == (fed.rounds, 3)
    # round-t traffic is served by the version published at round t-1
    assert served.served_metric[1, 2] == pytest.approx(float(served.accuracy[0]))
    assert served.served_metric[:, 1].tolist() == list(range(fed.rounds))


class _Snapshot(RoundHook):
    """Clones version 1 (round 0's params) when it is published."""

    def __init__(self, publisher):
        self.publisher, self.copy = publisher, None

    def on_round_end(self, ctx):
        if ctx.round_idx == 0:
            self.copy = {k: v.clone() for k, v in self.publisher.registry.get(1).params.items()}


@pytest.mark.parametrize("aggregator", ["fedavg", "fedavgm"])
def test_published_version_is_never_written(models, aggregator):
    """Publishing keeps a reference (no copy), so nothing may write into a
    published tensor: version 1, published at round 0, is bitwise what it
    was after two more rounds, and the run's final params are another
    object."""
    _, tm = models
    fed = lm_fed()
    data = make_lm_data(fed, vocab=64, seq_len=8)
    hook = PublishHook()
    snap = _Snapshot(hook)
    res = FederatedSpec(tm, fed, data, steps_per_round=2, hooks=[hook, snap], device="cpu",
                        aggregator=aggregator).build().run()
    v1 = hook.registry.get(1).params
    assert v1 is not res.params and len(hook.registry) == fed.rounds + 1
    for k, p in snap.copy.items():
        assert torch.equal(v1[k].view(torch.uint8), p.view(torch.uint8)), k
    assert any(not torch.equal(v1[k], res.params[k]) for k in v1)


def test_publish_gate_min_metric(models):
    """min_metric gating: sub-threshold rounds withhold their publish, the
    serve tier keeps the last good version, and lag grows."""
    _, tm = models
    fed = lm_fed()
    data = make_lm_data(fed, vocab=64, seq_len=8)
    hook = PublishHook(min_metric=1e9, eval_every=0,
                       traffic=TrafficConfig(rate=2.0, prompt_len=(2, 3), output_len=(3, 4),
                                             seed=2),
                       batch_width=2, max_len=8)
    res = FederatedSpec(tm, fed, data, steps_per_round=2, hooks=[hook],
                        device="cpu").build().run()
    s = res.serving
    assert s["versions_published"] == 1 and s["publishes_skipped"] == fed.rounds
    assert s["latest_version"] == 0 and s["max_lag_rounds"] == fed.rounds
    assert res.served_metric is None


def test_publish_hook_refuses_non_decode_model():
    model = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8))
    fed = lm_fed(rounds=1)
    data = make_vision_data(fed, train_per_class=8, test_per_class=4, noise=0.3)
    with pytest.raises(ValueError, match="no decode"):
        FederatedSpec(model, fed, data, steps_per_round=2, device="cpu",
                      hooks=[PublishHook(traffic=TrafficConfig())]).build().run()


# ---------------------------------------------------------------------------
# The launcher's checkpoint resolution
# ---------------------------------------------------------------------------


class TestServeCheckpointResolution:
    def test_reference_snapshot_restores_and_mismatch_is_loud(self, tmp_path, models):
        """A directory the reference's CheckpointHook wrote: the port's
        ``resolve_params`` returns the reference's final params bitwise; a
        different architecture's template raises, with no legacy fallback."""
        jm, tm = models
        jfed = JaxFedConfig(**{**FED_KW, "rounds": 2})
        jdata = jax_make_lm_data(jfed, vocab=64, seq_len=8)
        ref = JaxFederatedSpec(jm, jfed, jdata, steps_per_round=2, hooks=[
            JaxCheckpointHook(str(tmp_path), every=1)]).build().run()
        params, desc, rnd = resolve_params(tm, str(tmp_path), device="cpu")
        assert rnd == 2 and "sync/flat" in desc and "round 2" in desc
        want = params_from_jax(jax.tree.map(np.asarray, ref.params))
        assert sorted(params) == sorted(want)
        for k, p in want.items():
            assert params[k].dtype == p.dtype and torch.equal(
                params[k].view(torch.uint8), p.view(torch.uint8)), k
        other = build_model(smoke_variant(get_config("qwen2-0.5b")))
        with pytest.raises(CheckpointMismatchError):
            resolve_params(other, str(tmp_path), device="cpu")

    def test_port_snapshot_and_fresh_init(self, tmp_path, models):
        _, tm = models
        fed = lm_fed(rounds=2)
        data = make_lm_data(fed, vocab=64, seq_len=8)
        res = FederatedSpec(tm, fed, data, steps_per_round=2, device="cpu",
                            hooks=[CheckpointHook(str(tmp_path))]).build().run()
        params, desc, rnd = resolve_params(tm, str(tmp_path), device="cpu")
        assert rnd == 2 and "sync/flat" in desc
        for k, p in res.params.items():
            assert torch.equal(params[k].view(torch.uint8), p.view(torch.uint8)), k
        fresh, desc, rnd = resolve_params(tm, None, device="cpu")
        assert rnd == -1 and "fresh init" in desc and sorted(fresh) == sorted(res.params)


def test_examples_run_on_the_cpu(capsys):
    from repro_torch.examples import serve_global_model
    from repro_torch.launch import serve as launch_serve

    gen = serve_global_model.main(["--tokens", "3", "--batch", "2", "--arch", "qwen2-0.5b",
                                   "--device", "cpu"])
    assert gen.shape == (2, 3)
    launch_serve.main(["--device", "cpu", "--requests", "3", "--tokens", "4"])
    launch_serve.main(["--device", "cpu", "--arch", "mamba2-370m", "--oneshot",
                       "--tokens", "2", "--batch", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "batch=2: 2 tokens" in out
