"""The MoE decoder (moe family) of the port against the reference, one
device's expert share, and the federated LM path on it.

Model: ``smoke_variant(kimi-k2-1t-a32b)``: 2 layers, d_model 256, 4 heads
(2 KV heads) of 64, 4 experts of d_ff 512, top-2, vocab 512, untied
embeddings. Weights are the reference's ``init_params`` output carried with
``repro_torch.convert``; inputs are drawn with numpy from a seed. The full
width is checked by names, shapes and dtypes only (``jax.eval_shape``).

The reference's batched executor cannot run this family: ``jax.vmap`` of
``jax.lax.ragged_dot`` over the client axis raises NotImplementedError
("ragged_dot vmap over any dim but 0 - NYI", jax 0.9.0). The port's batched
(vmapped) runs are therefore held against the reference's sequential
executor; the port's own batched and sequential runs agree bitwise.

Tolerances:
  * Routing in f32: gates and aux 1e-6 relative, experts equal (forced ties
    too: the lower index first, as ``lax.top_k``; there the gates to 4e-6,
    three equal gates summed in another order).
  * The MoE FFN in f32: 1e-5 of the largest entry (sums in another order);
    in bf16 within 2 bf16 ulp of each entry plus 1 ulp of the largest
    (both packages round each product once from f32, then add k rows in bf16
    in the same order; a 1-ulp change of one row can carry into the sum).
  * The whole model with every dtype f32 (both packages' DEFAULT_DTYPE
    patched to float32, ROADMAP queue 3 (e)): logits 1e-5 (measured 2.6e-6),
    loss 1e-6 relative, gradients within 1e-5 of each leaf's largest entry
    (measured 1.8e-6). In bf16: logits within 2 bf16 ulp of the largest
    logit (measured 1.1), loss 1e-3 relative, gradients within 3 % of each
    leaf's largest entry (measured 1.0 %).
  * The federated slice (8 clients, m = 4, 3 rounds × 3 steps, batch 8,
    seq 32) on the reference's initial params and per-round Gumbel noise:
    selection histories equal. In f32 (DEFAULT_DTYPE patched in both) train
    loss to 1e-5 relative (measured 4.5e-6) and exp(-loss) to 1e-4 (measured
    4.6e-5). In bf16 train loss to 1e-4 (measured 2.5e-5) and exp(-loss) to
    1e-3 (measured 2.6e-4): with equal params and batch the first step's loss
    already differs by 1.4e-5, the 1-ulp logit gap of the bf16 forward.
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
from repro.fed import run_federated as jax_run_federated
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro_torch.configs import FedConfig, expert_share, get_config, smoke_variant
from repro_torch.convert import expert_share_params, params_from_jax, params_to_jax
from repro_torch.data import make_lm_data
from repro_torch.fed import FederatedSpec, run_federated
from repro_torch.fed.engine import default_eval
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.models import build_model, moe

from test_torch_flash import bf16_ulp, np32
from test_torch_slice import reference_draws

ARCH = "kimi-k2-1t-a32b"
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
def pair():
    jm = jax_build_model(jax_smoke_variant(jax_get_config(ARCH)))
    tm = build_model(smoke_variant(get_config(ARCH)))
    jp = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(1)))
    return jm, tm, jp, params_from_jax(jp)


def batch(cfg, b=2, s=40, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return ({"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)},
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})


def layer0(jp, dtype=None):
    """Layer 0's MoE params, reference (jnp) and port (torch) copies."""
    jl = {k: v[0] for k, v in jp["layers"]["moe"].items()}
    if dtype is not None:
        jl = {k: v.astype(dtype) for k, v in jl.items()}
    tl = {k: v for k, v in params_from_jax(jl).items()}
    return {k: jnp.asarray(v) for k, v in jl.items()}, tl


def activations(b, s, d, seed, dtype):
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def assert_close(got, want, dtype, ulps=2):
    g, w = np32(got), np32(want)
    if dtype == "float32":
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), np.abs(g - w).max()
    else:
        top = bf16_ulp(np.abs(w).max())
        assert np.all(np.abs(g - w) <= ulps * bf16_ulp(np.abs(w)) + top), np.abs(g - w).max()


# ---------------------------------------------------------------------------
# Configs, names, shapes, conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "grok-1-314b"])
def test_configs_are_the_reference_configs(arch):
    full, want = get_config(arch), jax_get_config(arch)
    smoke, want_smoke = smoke_variant(full), jax_smoke_variant(want)
    for f in dataclasses.fields(full):
        assert getattr(full, f.name) == getattr(want, f.name), f.name
        assert getattr(smoke, f.name) == getattr(want_smoke, f.name), f.name
    assert full.expert_range == range(full.num_experts)
    if arch == ARCH:
        assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
                full.resolved_head_dim, full.d_ff, full.num_experts,
                full.num_experts_per_tok, full.vocab_size) == \
            (61, 7168, 64, 8, 112, 2048, 384, 8, 163840)
        assert (smoke.num_layers, smoke.d_model, smoke.num_heads, smoke.num_kv_heads,
                smoke.d_ff, smoke.num_experts, smoke.num_experts_per_tok,
                smoke.vocab_size) == (2, 256, 4, 2, 512, 4, 2, 512)


def test_expert_share_keeps_every_width():
    full = get_config(ARCH)
    share = expert_share(full, experts_here=8, first_expert=0, vocab_size=20480,
                         num_layers=2)
    for f in dataclasses.fields(full):
        if f.name not in ("name", "vocab_size", "num_layers"):
            assert getattr(share, f.name) == getattr(full, f.name), f.name
    assert (share.expert_range, share.padded_vocab, share.num_layers) == \
        (range(0, 8), 20480, 2)
    assert "48 devices, 8 each" in share.expert_deployment
    with pytest.raises(ValueError, match="share"):
        expert_share(full, experts_here=8, first_expert=380)
    with pytest.raises(ValueError, match="moe"):
        expert_share(get_config("qwen2-0.5b"), experts_here=1)


def _named(cfg):
    return {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
            for n, p in build_model(cfg).module.named_parameters()}


def test_full_width_names_shapes_dtypes_match_reference():
    """At full width, without arrays: the reference's ``init_params`` traced
    by ``jax.eval_shape`` against the port's meta-device module; then the
    chip share's counts (8 of 384 experts, 20 480 vocabulary rows, 2 layers)."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    shapes = jax.eval_shape(lambda k: jmoe.init_params(k, jcfg), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(path, simple=True, separator="."): (tuple(a.shape),
                                                                       str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(shapes)}
    got = _named(cfg)
    assert got == want
    assert got["layers.moe.w_gate"] == ((61, 384, 7168, 2048), "bfloat16")
    assert got["layers.moe.router"] == ((61, 7168, 384), "float32")

    share = _named(expert_share(cfg, experts_here=8, vocab_size=20480, num_layers=2))
    count = {n: int(np.prod(s)) for n, (s, _) in share.items()}
    assert sum(v for n, v in count.items() if n.startswith("layers.attn.")) == 2 * 115_605_504
    assert count["layers.moe.router"] == 2 * 2_752_512
    assert sum(count[f"layers.moe.{w}"] for w in ("w_gate", "w_up", "w_down")) == \
        2 * 352_321_536
    assert count["layers.ln1"] + count["layers.ln2"] == 2 * 14_336
    assert count["embed.tok_embed"] + count["embed.unembed"] == 293_601_280
    assert sum(count.values()) == 1_234_996_224
    n_bytes = sum(v * (4 if share[n][1] == "float32" else 2) for n, v in count.items())
    assert n_bytes == 2_481_074_176


def test_smoke_names_shapes_dtypes_match_reference_and_init(pair):
    _, tm, _, tp = pair
    named = {n: (tuple(p.shape), p.dtype) for n, p in tm.module.named_parameters()}
    assert named == {n: (tuple(t.shape), t.dtype) for n, t in tp.items()}
    assert named["layers.moe.w_down"] == ((2, 4, 512, 256), torch.bfloat16)
    init = tm.init_params(torch.Generator().manual_seed(3))
    assert {n: (tuple(t.shape), t.dtype) for n, t in init.items()} == named
    again = tm.init_params(torch.Generator().manual_seed(3))
    assert all(torch.equal(init[n], again[n]) for n in init)
    # Truncated normal at 2σ, σ = 1/√fan_in (fan-in d_model for the router
    # and w_gate, d_ff for w_down).
    assert float(init["layers.moe.router"].abs().max()) <= 2.0 / 16 + 1e-6
    assert float(init["layers.moe.w_down"].float().abs().max()) <= 2.0 / np.sqrt(512) + 1e-3


def test_convert_round_trip_is_bitwise_and_expert_leaves_untransposed(pair):
    _, _, jp, tp = pair
    for name in ("w_gate", "w_up", "w_down", "router"):
        assert tuple(tp[f"layers.moe.{name}"].shape) == jp["layers"]["moe"][name].shape
    np.testing.assert_array_equal(np32(tp["layers.moe.w_gate"]),
                                  np32(jp["layers"]["moe"]["w_gate"]))
    back = params_to_jax(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=str(path))
    share = expert_share_params(tp, experts_here=2, first_expert=1)
    assert tuple(share["layers.moe.w_up"].shape) == (2, 2, 256, 512)
    assert torch.equal(share["layers.moe.w_up"], tp["layers.moe.w_up"][:, 1:3])
    assert share["layers.moe.router"] is tp["layers.moe.router"]


# ---------------------------------------------------------------------------
# Routing and the MoE FFN
# ---------------------------------------------------------------------------


def test_route_matches_reference(pair):
    _, _, jp, _ = pair
    jl, tl = layer0(jp)
    jx, tx = activations(1, 64, 256, 0, "bfloat16")
    gates, experts, aux = moe._route(tl["router"], tx.reshape(64, 256), 2)
    jg, je, ja = jmoe._route(jl["router"], jx.reshape(64, 256), 2)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(je))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(ja), rtol=1e-6)


def test_route_ties_go_to_the_lower_index():
    """Equal router columns give equal probabilities: top-k takes the lower
    expert index first, as ``lax.top_k``."""
    rng = np.random.default_rng(4)
    col = rng.normal(size=(16, 1)).astype(np.float32)
    router = np.concatenate([rng.normal(size=(16, 2)), col, col, col,
                             rng.normal(size=(16, 1)), col], 1).astype(np.float32)
    x = rng.normal(size=(40, 16)).astype(np.float32)
    x[:20] *= 0.0                                  # all-equal rows too
    gates, experts, aux = moe._route(torch.from_numpy(router), torch.from_numpy(x), 3)
    jg, je, ja = jmoe._route(jnp.asarray(router), jnp.asarray(x), 3)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(je))
    assert experts[0].tolist() == [0, 1, 2]
    # Three equal gates renormalized: the f32 sum of 1/3s rounds by its order.
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=4e-6)
    np.testing.assert_allclose(float(aux), float(ja), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(pair, dtype):
    jm, tm, jp, _ = pair
    jl, tl = layer0(jp, None if dtype == "bfloat16" else jnp.float32)
    jx, tx = activations(2, 40, 256, 1, dtype)
    out, aux = moe.moe_ffn(tm.cfg, tl, tx)
    jout, jaux = jmoe._moe_ffn_local(jm.cfg, jl, jx, model_axis=None, fsdp_axis=None)
    assert out.dtype == tx.dtype and out.shape == (2, 40, 256)
    assert_close(out, jout, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert tgmm.LAUNCHES["grouped_matmul"] == 0


def test_moe_ffn_vmaps_over_shared_weights_where_the_reference_cannot(pair):
    """A cohort's first local step: every client's activations against one
    set of weights (the batched executor's ``in_dims=(None, 0)``). The port's
    vmapped MoE FFN equals the per-client loop bitwise; the reference's
    raises NotImplementedError inside ``ragged_dot``'s batching rule (jax
    0.9.0), which is why its batched executor cannot run this family
    (ROADMAP queue 3 (h)) and the federation tests run its sequential one."""
    jm, tm, jp, _ = pair
    jl, tl = layer0(jp)
    jx, tx = activations(3, 8, 256, 5, "bfloat16")
    tx = tx.reshape(3, 1, 8, 256)
    got = torch.func.vmap(lambda x: moe.moe_ffn(tm.cfg, tl, x)[0])(tx)
    for c in range(3):
        assert torch.equal(got[c], moe.moe_ffn(tm.cfg, tl, tx[c])[0])
    with pytest.raises(NotImplementedError, match="ragged_dot"):
        jax.vmap(lambda x: jmoe._moe_ffn_local(jm.cfg, jl, x, model_axis=None,
                                               fsdp_axis=None)[0])(jx.reshape(3, 1, 8, 256))


def _zero_absent(jl, first, here):
    keep = np.zeros(jl["w_gate"].shape[0], bool)
    keep[first:first + here] = True
    return {k: (v if k == "router" else
                jnp.where(jnp.asarray(keep)[:, None, None], v, jnp.zeros_like(v)))
            for k, v in jl.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_share_equals_reference_layer_with_absent_experts_zeroed(pair, dtype):
    """Experts 1–2 of 4 here: the port's share against the reference's whole
    layer whose experts 0 and 3 have zero weights (their pairs add exact
    zeros there, and nothing here)."""
    jm, tm, jp, _ = pair
    jl, tl = layer0(jp, None if dtype == "bfloat16" else jnp.float32)
    cfg = expert_share(tm.cfg, experts_here=2, first_expert=1)
    tl_share = {k: (v if k == "router" else v[1:3]) for k, v in tl.items()}
    jx, tx = activations(2, 40, 256, 2, dtype)
    out, aux = moe.moe_ffn(cfg, tl_share, tx)
    jout, jaux = jmoe._moe_ffn_local(jm.cfg, _zero_absent(jl, 1, 2), jx,
                                     model_axis=None, fsdp_axis=None)
    assert_close(out, jout, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_disjoint_shares_sum_to_the_whole_layer(pair, dtype):
    """Shares {0, 1} and {2, 3} summed equal the reference's whole layer;
    each share's aux is the whole layer's (the router sees all experts), so
    the aux counts once. In bf16 each share rounds its own partial sums: the
    gap is held to 2 ulp of each entry plus 2 of the largest."""
    jm, tm, jp, _ = pair
    jl, tl = layer0(jp, None if dtype == "bfloat16" else jnp.float32)
    jx, tx = activations(2, 40, 256, 3, dtype)
    total = 0
    for first in (0, 2):
        cfg = expert_share(tm.cfg, experts_here=2, first_expert=first)
        part, aux = moe.moe_ffn(cfg, {k: (v if k == "router" else v[first:first + 2])
                                      for k, v in tl.items()}, tx)
        total = total + part.to(torch.float32)
        jout, jaux = jmoe._moe_ffn_local(jm.cfg, jl, jx, model_axis=None, fsdp_axis=None)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if dtype == "float32":
        assert_close(total, jout, dtype)
    else:
        w = np32(jout)
        gap = np.abs(total.numpy() - w)
        assert np.all(gap <= 2 * bf16_ulp(np.abs(w)) + 2 * bf16_ulp(np.abs(w).max())), gap.max()


def test_share_model_matches_reference_with_absent_experts_zeroed(pair):
    """The whole smoke model with experts 2–3 of 4 here (sliced with
    ``convert.expert_share_params``) against the reference's model with
    experts 0–1 zeroed, in bf16."""
    jm, tm, jp, tp = pair
    cfg = expert_share(tm.cfg, experts_here=2, first_expert=2)
    share = build_model(cfg)
    tps = expert_share_params(tp, experts_here=2, first_expert=2)
    assert {n: tuple(p.shape) for n, p in share.module.named_parameters()} == \
        {n: tuple(t.shape) for n, t in tps.items()}
    jpz = jax.tree.map(lambda a: a, jp)
    for w in ("w_gate", "w_up", "w_down"):
        a = np.array(jp["layers"]["moe"][w])
        a[:, :2] = 0
        jpz["layers"]["moe"][w] = a
    tb, jb = batch(cfg, seed=4)
    logits = share.forward(tps, tb)
    want = np32(jm.forward(jpz, jb))
    assert np.abs(np32(logits) - want).max() <= 2 * bf16_ulp(np.abs(want).max())


def test_unported_paths_raise(pair):
    _, tm, _, tp = pair
    tb, _ = batch(tm.cfg)
    with pytest.raises(NotImplementedError, match="shard_map"):
        moe.forward(tm.cfg, tp, tb["tokens"], mesh=object())
    with pytest.raises(NotImplementedError, match="remat"):
        moe.forward(tm.cfg, tp, tb["tokens"], remat=True)
    for fn in (moe.cache_len, moe.init_cache, moe.decode_step):
        with pytest.raises(NotImplementedError, match="decode"):
            fn(tm.cfg, 1, 1)


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------


def _grads_close(got, want_tree, frac):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    for name in sorted(got):
        g, w = np32(got[name]), np32(want[name])
        assert got[name].dtype == want[name].dtype, name
        gap, scale = np.abs(g - w).max(), np.abs(w).max()
        assert gap <= frac * scale, (name, float(gap), float(scale))


def test_forward_loss_and_grads_match_reference_in_f32(pair, monkeypatch):
    monkeypatch.setattr(jmoe, "DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(moe, "DEFAULT_DTYPE", torch.float32)
    jm, tm, jp, tp = pair
    jp32 = jax.tree.map(lambda a: a.astype(np.float32), jp)
    tp32 = {k: v.to(torch.float32) for k, v in tp.items()}
    tb, jb = batch(tm.cfg)
    logits = tm.forward(tp32, tb)
    want = np.asarray(jm.forward(jp32, jb))
    assert logits.dtype == torch.float32 and logits.shape == (2, 40, 512)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-5)
    loss, grads = torch.func.grad_and_value(tm.loss)(tp32, tb)[::-1]
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp32, jb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    _grads_close(grads, jgrads, 1e-5)
    assert tgmm.LAUNCHES["grouped_matmul"] == 0


def test_forward_loss_and_grads_match_reference_in_bf16(pair):
    jm, tm, jp, tp = pair
    tb, jb = batch(tm.cfg, seed=1)
    logits = tm.forward(tp, tb)
    want = np32(jm.forward(jp, jb))
    assert logits.dtype == torch.bfloat16
    assert np.abs(np32(logits) - want).max() <= 2 * bf16_ulp(np.abs(want).max())
    loss, grads = torch.func.grad_and_value(tm.loss)(tp, tb)[::-1]
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    _grads_close(grads, jgrads, 0.03)


# ---------------------------------------------------------------------------
# The federated slice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setups():
    jfed, fed = JaxFedConfig(**FED_KW), FedConfig(**FED_KW)
    jmodel = jax_build_model(jax_smoke_variant(jax_get_config(ARCH)))
    model = build_model(smoke_variant(get_config(ARCH)))
    jdata = jax_make_lm_data(jfed, vocab=jmodel.cfg.vocab_size, seq_len=32)
    data = make_lm_data(fed, vocab=model.cfg.vocab_size, seq_len=32)
    draws = reference_draws(fed.seed, fed.num_clients, ROUNDS, jmodel)
    return (jfed, jmodel, jdata), (fed, model, data), draws


def _federate(setups, selector, params, jmodel=None):
    (jfed, jm, jdata), (fed, model, data), (_, noise) = setups
    ref = jax_run_federated(jmodel or jm, jfed, jdata, selector=selector,
                            steps_per_round=STEPS, client_execution="sequential")
    tfa.reset_launches()
    tgmm.reset_launches()
    engine = FederatedSpec(model, fed, data, selector=selector, steps_per_round=STEPS,
                           executor="batched", device="cpu",
                           noise=lambda t, k: torch.from_numpy(noise[t]),
                           init_params=params).build()
    assert engine.metric_name == "exp(-loss)"
    res = engine.run()
    np.testing.assert_array_equal(res.selected_history, np.asarray(ref.selected_history))
    assert res.selected_history.sum(1).tolist() == [fed.num_selected] * ROUNDS
    assert res.metric_name == ref.metric_name == "exp(-loss)"
    # CPU tensors take the plain versions
    assert tfa.LAUNCHES["flash_attention"] == tgmm.LAUNCHES["grouped_matmul"] == 0
    for name, p in res.params.items():
        assert p.dtype == params[name].dtype and bool(torch.isfinite(p).all()), name
    return res, ref


@pytest.mark.parametrize("selector", ["heterosel", "heterosel_pallas"])
def test_moe_federation_matches_reference(setups, selector):
    res, ref = _federate(setups, selector, setups[2][0])
    np.testing.assert_allclose(res.train_loss, ref.train_loss, rtol=1e-4)
    np.testing.assert_allclose(res.accuracy, ref.accuracy, rtol=1e-3)


def test_moe_federation_matches_reference_in_f32(setups, monkeypatch):
    monkeypatch.setattr(jmoe, "DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(moe, "DEFAULT_DTYPE", torch.float32)
    jm = setups[0][1]
    jm32 = dataclasses.replace(jm, init_params=lambda key: jax.tree.map(
        lambda a: a.astype(jnp.float32), jm.init_params(key)))
    params32 = {k: v.to(torch.float32) for k, v in setups[2][0].items()}
    res, ref = _federate(setups, "heterosel", params32, jmodel=jm32)
    np.testing.assert_allclose(res.train_loss, ref.train_loss, rtol=1e-5)
    np.testing.assert_allclose(res.accuracy, ref.accuracy, rtol=1e-4)


def test_run_federated_takes_the_moe_family():
    """The public entry point on a tiny run: exp(-loss) in (0, 1], named so,
    and the eval is exp(-loss) of the model's loss (aux included) unchanged."""
    model = build_model(dataclasses.replace(smoke_variant(get_config(ARCH)), num_layers=1))
    fed = FedConfig(num_clients=4, participation=0.5, rounds=2, local_epochs=1,
                    local_batch=2, lr=0.05, seed=0)
    data = make_lm_data(fed, vocab=model.cfg.vocab_size, seq_len=8)
    res = run_federated(model, fed, data, selector="heterosel_pallas", device="cpu")
    assert res.metric_name == "exp(-loss)"
    assert np.all((res.accuracy > 0) & (res.accuracy <= 1))
    assert "peak_exp(-loss)" in res.labeled_summary()
    eval_batch = data.eval_batch()
    assert default_eval(model, res.params, eval_batch) == pytest.approx(
        float(torch.exp(-model.loss(res.params, eval_batch))), rel=0, abs=0)
