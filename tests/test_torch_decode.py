"""Decode (one token against a cache) of every decoding family in the port
against the reference's ``decode_step``, and teacher-forced decode against
the port's own forward.

Models: the smoke variants of qwen2-0.5b (dense; and with a sliding window
of 4, the ring cache), mamba2-370m (ssm), zamba2-7b at 5 layers (hybrid: two
applications of the shared block, each with its own KV cache, and one
trailing Mamba2 layer) and llama-3.2-vision-90b (vlm, its cross-attention
cache warmed from numpy-drawn vision embeddings). The moe family's case is
``test_torch_moe.py::test_decode_step_matches_reference_in_f32`` (it uses
that file's weights). Weights are the reference's ``init_params`` output
carried with ``repro_torch.convert``; prompts are drawn with numpy from a
seed.

Tolerances:
  * Parity, every dtype f32 (``DEFAULT_DTYPE`` patched to float32 in both
    packages' family modules, ROADMAP queue 3 (e); every cache leaf cast to
    f32 before the first step, so the KV caches, which ``init_kv_cache``
    makes bf16 whatever the patch, hold f32 too): at every position the
    logits, and after the prompt every cache leaf, agree to 1e-5 relative
    (of each array's largest entry); the positions that no step has written
    are exactly 0 in both.
  * Teacher-forced decode against the forward over the same tokens, in the
    default bf16: the reference's own bounds
    (``tests/test_models_smoke.py``), atol 0.15 and rtol 0.05 for the
    dense family, atol 0.25 and rtol 0.08 for the SSM (the chunked scan
    and the recurrence round in other places).
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
from repro.models import dense as jdense
from repro.models import hybrid as jhybrid
from repro.models import mamba2 as jmamba
from repro.models import vlm as jvlm
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.models import attention, build_model, dense, hybrid, mamba2, vlm

from test_torch_flash import np32
from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)

# family case → (arch, config overrides, (reference, port) modules whose
# DEFAULT_DTYPE the f32 runs patch)
CASES = {
    "dense": ("qwen2-0.5b", {}, ((jdense, dense),)),
    "ring": ("qwen2-0.5b", {"sliding_window": 4}, ((jdense, dense),)),
    "ssm": ("mamba2-370m", {}, ((jmamba, mamba2),)),
    "hybrid": ("zamba2-7b", {"num_layers": 5}, ((jhybrid, hybrid), (jmamba, mamba2))),
    "vlm": ("llama-3.2-vision-90b", {}, ((jvlm, vlm),)),
}
PROMPT = 7
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files on parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def configs(arch, **over):
    return (dataclasses.replace(jax_smoke_variant(jax_get_config(arch)), **over),
            dataclasses.replace(smoke_variant(get_config(arch)), **over))


def f32_params(jm, seed=1):
    """The reference's init (jitted: eager init compiles op by op) in f32,
    and the same carried to the port."""
    jp = jax.tree.map(lambda a: np.array(a, np.float32),
                      jax.jit(jm.init_params)(jax.random.PRNGKey(seed)))
    return jp, params_from_jax(jp)


def prompt(cfg, b=2, s=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def vision(cfg, b=2, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)


def assert_close(got, want, what):
    got, want = np32(got), np32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= RTOL * scale, (what, gap, scale)
    assert np.array_equal(got == 0, want == 0) or gap == 0, what


def teacher_force_both(jm, tm, jp, tp, toks, jcache, tcache):
    """Feed ``toks`` (B, S) one position at a time through both packages'
    decode steps from the given caches; compare the logits at every
    position. Returns both final caches."""
    step = jax.jit(jm.decode_step)
    for pos in range(toks.shape[1]):
        want, jcache = step(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos))
        got, tcache = tm.decode_step(tp, tcache, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        assert_close(got, want, f"logits at position {pos}")
    return jcache, tcache


def f32_caches(jm, tm, b, max_len):
    """Fresh caches of both packages, every leaf f32 (equal zeros)."""
    jc = {k: jnp.zeros(v.shape, jnp.float32) for k, v in jm.init_cache(b, max_len).items()}
    tc = {k: v.to(torch.float32) for k, v in tm.init_cache(b, max_len, device="cpu").items()}
    assert sorted(jc) == sorted(tc)
    for name in jc:
        assert tuple(jc[name].shape) == tuple(tc[name].shape), name
    return jc, tc


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_step_matches_reference_in_f32(case, monkeypatch):
    arch, over, patched = CASES[case]
    for jmod, tmod in patched:
        monkeypatch.setattr(jmod, "DEFAULT_DTYPE", jnp.float32)
        monkeypatch.setattr(tmod, "DEFAULT_DTYPE", torch.float32)
    jcfg, cfg = configs(arch, **over)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jp, tp = f32_params(jm)
    toks = prompt(cfg)
    b, max_len = toks.shape[0], PROMPT + 3
    jc, tc = f32_caches(jm, tm, b, max_len)
    if case == "vlm":
        ve = vision(cfg)
        jc = jvlm.warm_cross_cache(jcfg, jp, jc, jnp.asarray(ve))
        tc = vlm.warm_cross_cache(cfg, tp, tc, torch.from_numpy(ve))
        for name in ("xk", "xv"):
            assert_close(tc[name], jc[name], f"warmed {name}")
    jc, tc = teacher_force_both(jm, tm, jp, tp, toks, jc, tc)
    for name in jc:
        assert tc[name].dtype == torch.float32, name
        assert_close(tc[name], jc[name], f"cache leaf {name}")


def test_cache_shapes_and_dtypes_match_reference():
    """In the default dtypes: every family's fresh cache has the reference's
    leaves, shapes and dtypes (KV and conv caches bf16, SSM states f32), the
    hybrid's tail state one layer deep where it has no trailing layer."""
    for arch, over in (("qwen2-0.5b", {}), ("qwen2-0.5b", {"sliding_window": 4}),
                       ("kimi-k2-1t-a32b", {}), ("mamba2-370m", {}), ("zamba2-7b", {}),
                       ("zamba2-7b", {"num_layers": 5}), ("llama-3.2-vision-90b", {})):
        jcfg, cfg = configs(arch, **over)
        jm, tm = jax_build_model(jcfg), build_model(cfg)
        want = jax.eval_shape(lambda: jm.init_cache(3, 11))
        got = tm.init_cache(3, 11, device="cpu")
        assert sorted(got) == sorted(want), arch
        for name, leaf in got.items():
            assert tuple(leaf.shape) == tuple(want[name].shape), (arch, name)
            assert str(leaf.dtype).split(".")[-1] == str(want[name].dtype), (arch, name)
            assert not leaf.any(), (arch, name)
    assert tuple(build_model(smoke_variant(get_config("zamba2-7b"))).init_cache(
        1, 4, device="cpu")["tail_ssm"].shape)[0] == 1


def test_non_decoding_families_have_no_decode():
    for arch in ("hubert-xlarge", "resnet18-cifar10"):
        m = build_model(smoke_variant(get_config(arch)))
        assert not m.has_decode and m.init_cache is None and m.decode_step is None
    for arch in ("qwen2-0.5b", "kimi-k2-1t-a32b", "mamba2-370m", "zamba2-7b",
                 "llama-3.2-vision-90b"):
        assert build_model(smoke_variant(get_config(arch))).has_decode


def test_cache_write_clamps_as_dynamic_update_slice():
    """Without the ring a position past the cache writes its last slot (the
    reference's ``lax.dynamic_update_slice`` clamps the start index), a
    negative one counts from the end; with the ring, pos % T. The caches
    passed in are not written."""
    rng = np.random.default_rng(5)
    ck = rng.standard_normal((2, 5, 2, 4)).astype(np.float32)
    cv = rng.standard_normal((2, 5, 2, 4)).astype(np.float32)
    k = rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
    v = rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
    from repro.models import attention as jattn
    for pos in (0, 3, 4, 5, 9, -2, -7):
        for ring in (False, True):
            tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
            got = attention.cache_write(tck, tcv, torch.from_numpy(k), torch.from_numpy(v),
                                        pos, ring=ring)
            want = jattn.cache_write(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(k),
                                     jnp.asarray(v), jnp.int32(pos), ring=ring)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w)), (pos, ring)
            assert np.array_equal(tck.numpy(), ck) and np.array_equal(tcv.numpy(), cv)


@pytest.mark.parametrize("arch,atol,rtol", [("qwen2-0.5b", 0.15, 0.05),
                                            ("mamba2-370m", 0.25, 0.08)])
def test_teacher_forced_decode_reproduces_forward(arch, atol, rtol):
    """bf16, the port against itself: the prompt fed one position at a time
    through ``decode_step`` gives the forward's logits over the prompt."""
    cfg = smoke_variant(get_config(arch))
    tm = build_model(cfg)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(prompt(cfg, s=12, seed=2))
    with torch.no_grad():
        full = tm.forward(tp, {"tokens": toks})
        cache = tm.init_cache(toks.shape[0], toks.shape[1], device="cpu")
        outs = []
        for pos in range(toks.shape[1]):
            logits, cache = tm.decode_step(tp, cache, toks[:, pos:pos + 1], pos)
            outs.append(logits[:, 0])
    np.testing.assert_allclose(np32(full), np32(torch.stack(outs, 1)), atol=atol, rtol=rtol)


def test_block_forward_takes_and_returns_the_state(monkeypatch):
    """mamba2's ``block_forward`` with an entering state ``h0`` and
    ``return_state`` (the reference's keywords), in f32 against the
    reference: output and leaving state to 1e-5 of their largest entry."""
    monkeypatch.setattr(jmamba, "DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(mamba2, "DEFAULT_DTYPE", torch.float32)
    jcfg, cfg = configs("mamba2-370m")
    jp, tp = f32_params(jax_build_model(jcfg))
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["block"])
    tl = {k[len("layers.block."):]: v[0] for k, v in tp.items() if k.startswith("layers.block.")}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)).astype(np.float32)
    want, want_h = jmamba.block_forward(jcfg, jl, jnp.asarray(x), h0=jnp.asarray(h0),
                                        return_state=True)
    got, got_h = mamba2.block_forward(cfg, tl, torch.from_numpy(x), h0=torch.from_numpy(h0),
                                      return_state=True)
    assert_close(got, want, "output")
    assert_close(got_h, want_h, "leaving state")
    assert torch.equal(mamba2.block_forward(cfg, tl, torch.from_numpy(x)),
                       mamba2.block_forward(cfg, tl, torch.from_numpy(x), return_state=True)[0])
