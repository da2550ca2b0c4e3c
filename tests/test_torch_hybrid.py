"""The zamba2 hybrid (Mamba2 blocks and one shared attention block) of the
port against the reference (its federation: ``test_torch_hybrid_fed.py``).

Models: ``smoke_variant(zamba2-7b)``: 2 layers with ``shared_attn_every=2``
(one super-block of one Mamba2 layer and the shared block, no trailing
layer: the one-layer ``tail_mamba`` stack that no layer reads), d_model
256, 4 MHA heads of 64, d_ff 512, state 16, 16 SSM heads of 32, chunk 32,
vocab 512; and the same at ``num_layers=5`` (two applications of the
shared block and one trailing Mamba2 layer). Weights are the reference's
``init_params`` output carried with ``repro_torch.convert``; inputs are
drawn with numpy from a seed. The full width is checked by names, shapes
and dtypes only (``jax.eval_shape``).

Tolerances (those of ``test_torch_ssm.py`` and ``test_torch_lm_model.py``):
  * every dtype f32 (``DEFAULT_DTYPE`` patched to float32 in both packages'
    hybrid and mamba2 modules): logits atol 1e-5, loss rtol 1e-6, every
    leaf's gradient within 1e-5 of its largest entry; the shared block's
    gradient is the sum over its applications, the unread tail's exactly 0;
  * in the default bf16, on the smoke variant: logits within 4 bf16 ulp of
    the largest logit, loss rtol 1e-3, gradients within 3 % of each leaf's
    largest entry. The 5-layer variant is held in f32 only: in bf16 the
    reference's own gradient of its trailing layer is up to 4.2 % (largest
    entry) and 3.4 % (norm) off its f32 gradient, and the port's as far, so
    3 % there measures rounding, not the port.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_variant as jax_smoke_variant
from repro.models import build_model as jax_build_model
from repro.models import hybrid as jhybrid
from repro.models import mamba2 as jmamba
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import build_model, hybrid, mamba2

from test_torch_flash import bf16_ulp, np32

ARCH = "zamba2-7b"
VARIANTS = {"smoke": {}, "5 layers": {"num_layers": 5}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files on parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def configs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(jax_smoke_variant(jax_get_config(ARCH)), **kw),
            dataclasses.replace(smoke_variant(get_config(ARCH)), **kw))


@pytest.fixture(scope="module")
def pairs():
    """(reference model, port model, reference params, port params) by
    variant. The 5-layer weights are the reference's init; the smoke
    variant's are their first super-block with the 5-layer tail stack (which
    the smoke variant holds but does not read)."""
    out = {}
    for variant in ("5 layers", "smoke"):
        jcfg, cfg = configs(variant)
        jm, tm = jax_build_model(jcfg), build_model(cfg)
        if variant == "5 layers":
            jp = jax.tree.map(np.array, jax.jit(jm.init_params)(jax.random.PRNGKey(1)))
        else:
            jp = dict(out["5 layers"][2])
            jp["super_mamba"] = jax.tree.map(lambda a: a[:1], jp["super_mamba"])
        out[variant] = (jm, tm, jp, params_from_jax(jp))
    return out


def reference_values(jm, jp, jb):
    """The reference's logits, loss and gradients in one compiled call."""
    def f(p, b):
        return jm.forward(p, b), jax.value_and_grad(jm.loss)(p, b)

    logits, (loss, grads) = jax.jit(f)(jp, jb)
    return np32(logits), float(loss), grads


def batch(cfg, b=2, s=40, seed=0):
    """Tokens of a length that is not a multiple of the chunk (32)."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return ({"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)},
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})


def test_configs_and_layer_plan_are_the_reference():
    full, want = get_config(ARCH), jax_get_config(ARCH)
    smoke, want_smoke = smoke_variant(full), jax_smoke_variant(want)
    for f in dataclasses.fields(full):
        assert getattr(full, f.name) == getattr(want, f.name), f.name
        assert getattr(smoke, f.name) == getattr(want_smoke, f.name), f.name
    assert (full.num_layers, full.d_model, full.num_heads, full.resolved_head_dim,
            full.d_ff, full.ssm_state, full.ssm_heads, full.padded_vocab) == \
        (81, 3584, 32, 112, 14336, 64, 112, 32000)
    for layers in (2, 5, 12, 81):
        c = dataclasses.replace(full, num_layers=layers)
        assert hybrid.layer_plan(c) == jhybrid.layer_plan(c)
    assert hybrid.layer_plan(full) == (13, 5, 3)
    assert hybrid.layer_plan(smoke) == (1, 1, 0)


def test_full_width_names_shapes_dtypes_match_reference():
    """At full width and at chip_smoke.py's 12-layer cut, without arrays."""
    for layers, want_params in ((81, None), (12, 1_292_666_352)):
        cfg = dataclasses.replace(get_config(ARCH), num_layers=layers)
        jcfg = dataclasses.replace(jax_get_config(ARCH), num_layers=layers)
        shapes = jax.eval_shape(lambda k: jhybrid.init_params(k, jcfg), jax.random.PRNGKey(0))
        want = {jax.tree_util.keystr(path, simple=True, separator="."):
                (tuple(a.shape), str(a.dtype))
                for path, a in jax.tree_util.tree_leaves_with_path(shapes)}
        got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
               for n, p in build_model(cfg).module.named_parameters()}
        assert got == want
        if want_params:
            assert sum(int(np.prod(s)) for s, _ in got.values()) == want_params


def test_names_shapes_dtypes_match_reference_and_init(pairs):
    for variant, (_, tm, _, tp) in pairs.items():
        named = {n: (tuple(p.shape), p.dtype) for n, p in tm.module.named_parameters()}
        assert named == {n: (tuple(t.shape), t.dtype) for n, t in tp.items()}, variant
        init = tm.init_params(torch.Generator().manual_seed(3))
        assert {n: (tuple(t.shape), t.dtype) for n, t in init.items()} == named
        again = tm.init_params(torch.Generator().manual_seed(3))
        assert all(torch.equal(init[n], again[n]) for n in init)
        assert float(init["shared_attn.mlp.w_up"].float().abs().max()) <= 2.0 / 16 + 1e-3
        assert bool((init["super_mamba.block.dt_bias"] == -2.0).all())
    named = dict(pairs["smoke"][1].module.named_parameters())
    assert tuple(named["super_mamba.block.in_x"].shape) == (1, 1, 256, 512)
    assert tuple(named["tail_mamba.block.in_x"].shape) == (1, 256, 512)   # read by no layer
    assert tuple(named["shared_attn.attn.wq"].shape) == (256, 4, 64)


def test_convert_round_trip_is_bitwise(pairs):
    _, _, jp, tp = pairs["5 layers"]
    back = params_to_jax(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=str(path))


def _grads_close(got, want_tree, frac):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    for name in sorted(got):
        g, w = np32(got[name]), np32(want[name])
        assert got[name].dtype == want[name].dtype, name
        gap, scale = np.abs(g - w).max(), np.abs(w).max()
        assert gap <= frac * scale, (name, float(gap), float(scale))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_loss_and_grads_match_reference_in_f32(pairs, variant, monkeypatch):
    for module in (jhybrid, jmamba):
        monkeypatch.setattr(module, "DEFAULT_DTYPE", jnp.float32)
    for module in (hybrid, mamba2):
        monkeypatch.setattr(module, "DEFAULT_DTYPE", torch.float32)
    jm, tm, jp, tp = pairs[variant]
    jp32 = jax.tree.map(lambda a: a.astype(np.float32), jp)
    tp32 = {k: v.to(torch.float32) for k, v in tp.items()}
    tb, jb = batch(tm.cfg)
    logits = tm.forward(tp32, tb)
    want, jloss, jgrads = reference_values(jm, jp32, jb)
    assert logits.dtype == torch.float32 and logits.shape == (2, 40, 512)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-5)
    loss, grads = torch.func.grad_and_value(tm.loss)(tp32, tb)[::-1]
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    _grads_close(grads, jgrads, 1e-5)
    n_super, _, tail = hybrid.layer_plan(tm.cfg)
    assert n_super == {"smoke": 1, "5 layers": 2}[variant]
    if not tail:   # the unread tail stack: exactly zero in both packages
        for name, g in grads.items():
            if name.startswith("tail_mamba."):
                assert not bool(g.any()), name
        assert not any(np.any(a) for a in jax.tree.leaves(jgrads["tail_mamba"]))
    assert tfa.LAUNCHES["flash_attention"] == tssd.LAUNCHES["ssd_chunk"] == 0


def test_shared_block_gradient_is_the_sum_over_its_applications(pairs, monkeypatch):
    """With every dtype f32, the shared block's gradient equals the sum of the
    gradients of two blocks that hold its weights, one per application."""
    for module in (hybrid, mamba2):
        monkeypatch.setattr(module, "DEFAULT_DTYPE", torch.float32)
    _, tm, _, tp = pairs["5 layers"]
    tp32 = {k: v.to(torch.float32) for k, v in tp.items()}
    tb, _ = batch(tm.cfg, seed=2)
    shared = [k for k in tp32 if k.startswith("shared_attn.")]
    calls = []
    real = hybrid._attn_sub

    def per_application(cfg, x, positions, sp, copies):
        i = len(calls)
        calls.append(i)
        return real(cfg, x, positions, copies[i])

    def loss_split(copies, rest):
        calls.clear()
        monkeypatch.setattr(hybrid, "_attn_sub", lambda cfg, x, pos, sp:
                            per_application(cfg, x, pos, sp, copies))
        try:
            return tm.loss(rest, tb)
        finally:
            monkeypatch.setattr(hybrid, "_attn_sub", real)

    from repro_torch.models.layers import nest
    copies = [nest({k: tp32[k].clone() for k in shared}, "shared_attn.") for _ in range(2)]
    g_split = torch.func.grad(loss_split)(copies, tp32)
    assert len(calls) == 2
    g_shared = torch.func.grad(tm.loss)(tp32, tb)
    for k in shared:
        path = k[len("shared_attn."):].split(".")
        parts = []
        for c in g_split:
            node = c
            for p in path:
                node = node[p]
            parts.append(node)
        torch.testing.assert_close(g_shared[k], parts[0] + parts[1], rtol=1e-5, atol=1e-7)
        assert float(parts[0].abs().max()) > 0 and float(parts[1].abs().max()) > 0, k


def test_forward_loss_and_grads_match_reference_in_bf16(pairs):
    jm, tm, jp, tp = pairs["smoke"]
    tb, jb = batch(tm.cfg, seed=1)
    logits = tm.forward(tp, tb)
    want, jloss, jgrads = reference_values(jm, jp, jb)
    assert logits.dtype == torch.bfloat16
    assert np.abs(np32(logits) - want).max() <= 4 * bf16_ulp(np.abs(want).max())
    loss, grads = torch.func.grad_and_value(tm.loss)(tp, tb)[::-1]
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-3)
    _grads_close(grads, jgrads, 0.03)


def test_vmapped_cohort_calls_k5_once_per_application(pairs, monkeypatch):
    """Under ``torch.func.vmap`` over clients, the forward calls K5 once per
    application of the shared block and K7 once per Mamba2 layer, for the
    whole cohort (the kernels' vmap rules fold the client axis)."""
    _, tm, _, tp = pairs["5 layers"]
    counts = {"flash": 0, "ssd": 0}
    real_fa, real_ssd = tfa.flash_attention_fwd, tssd.ssd_chunk

    def fa(*a, **kw):
        counts["flash"] += 1
        return real_fa(*a, **kw)

    def ssd(*a, **kw):
        counts["ssd"] += 1
        return real_ssd(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention_fwd", fa)
    monkeypatch.setattr(tssd, "ssd_chunk", ssd)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, size=(3, 2, 32)).astype(np.int32))
    stacked = {k: v.expand(3, *v.shape) for k, v in tp.items()}
    out = torch.func.vmap(lambda p, t: tm.loss(p, {"tokens": t, "labels": t}))(stacked, toks)
    assert out.shape == (3,)
    n_super, per, tail = hybrid.layer_plan(tm.cfg)
    assert counts == {"flash": n_super, "ssd": n_super * per + tail} == {"flash": 2, "ssd": 3}
