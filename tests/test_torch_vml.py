"""The port's last CPU calls of MKL's vector math (VML) moved to
``kernels/_math`` (ROADMAP queue 3 (f)): the losses' logsumexp, the
staleness term's log1p, the scorers' and the eval's exp and the sampler's
log.

A CPU float ``torch.exp``/``log``/``log1p``/``logsumexp`` runs VML, whose
first call in a process, made on several intra-op threads at once, can
compute one thread's share at ~1.5e-4 relative error. Three checks:

  * none of the moved call sites dispatches one of those ops on the CPU (an
    op recorder around each; this is what the parent commit fails);
  * ``_math.log1p`` and ``_math.logsumexp`` are within 1 ulp of their f64
    values in f32, including |x| < 2^-24, 0 and the staleness range, and
    the losses within 1 ulp of the f32 loss through ``torch.logsumexp``;
  * in fresh processes on the default thread count, each moved call made
    first, at a size that spreads over the threads, is within 1 ulp of its
    f64 value, and the loss within 1 ulp of the loss through
    ``torch.logsumexp`` on one thread (one process alone, and three at
    once).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ModelConfig
from repro_torch.core import scoring, selection, state, theory
from repro_torch.fed.engine import default_eval
from repro_torch.kernels import _math
from repro_torch.kernels import score_select as tss
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import build_model, layers

VML_OPS = {"exp", "log", "log1p", "logsumexp", "expm1", "log_softmax", "softmax"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread_and_warm_vml():
    """One intra-op thread (the suite runs files on parallel workers), and
    torch's own exp/log/log1p run once on it, so the reference values below
    are not a first multi-threaded VML call."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    for f in (torch.exp, torch.log, torch.log1p):
        f(torch.ones(1))
    yield
    torch.set_num_threads(before)


def ulps(got: torch.Tensor, want: torch.Tensor) -> np.ndarray:
    """f32 units in the last place between finite f32 tensors, through their
    bit patterns mapped to one ordered integer line."""
    def line(t):
        b = t.contiguous().view(torch.int32).numpy().astype(np.int64)
        return np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(line(got) - line(want))


class Record(TorchDispatchMode):
    """The names of the aten ops dispatched on CPU tensors."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__.rstrip("_")
        self.ops.add(name)
        return func(*args, **(kwargs or {}))


def observed_state(k=40, seed=0):
    rng = np.random.default_rng(seed)
    st = state.init_client_state(k, rng.uniform(0, 0.69, k).astype(np.float32), device="cpu")
    for t in range(3):
        st = state.update_client_state(
            st, round_idx=t, selected_mask=torch.from_numpy(rng.uniform(size=k) > 0.5),
            observed_loss=torch.from_numpy(rng.uniform(0.1, 4, k).astype(np.float32)),
            observed_sqnorm=torch.from_numpy(rng.uniform(0, 2, k).astype(np.float32)))
    return st


def _lm_loss_and_grad():
    logits = torch.randn(2, 9, 300, requires_grad=True)
    labels = torch.randint(0, 300, (2, 9))
    mask = torch.rand(2, 9) > 0.5
    loss = layers.cross_entropy(logits, labels) + layers.cross_entropy(logits, labels, mask)
    loss.backward()


def _resnet_loss_and_eval():
    cfg = ModelConfig(name="r", family="resnet", num_layers=8, d_model=8, image_size=8)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = {"images": torch.randn(2, 8, 8, 3), "labels": torch.tensor([1, 3])}
    model.loss(params, batch)
    lm = build_model(ModelConfig(name="d", family="dense", num_layers=1, d_model=16,
                                 num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64))
    lp = lm.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, 64, (2, 8))
    default_eval(lm, lp, {"tokens": toks, "labels": toks})


def _scores():
    st = observed_state()
    cfg = scoring.HeteRoScoreConfig()
    scoring.compute_scores(st, 5, cfg)
    scoring.compute_scores(st, 5, cfg, staleness_override=torch.rand(40) * 30)
    tss.fused_score_probs_plain(*state.score_inputs(st), round_idx=5, tau=1.0, cfg=cfg)


def _theory():
    theory.exploration_lower_bound(torch.arange(0.0, 30.0), 4,
                                   selection.SelectorConfig(), scoring.HeteRoScoreConfig())


def _sampler():
    probs = torch.softmax(torch.randn(40), 0)
    selection.sample_clients(torch.zeros(40), probs, 6)


def _recurrence():
    b, s, nh, hp, n = 1, 6, 2, 4, 3
    tssd.ssd_recurrence(torch.randn(b, s, nh, hp), torch.rand(b, s, nh), -torch.rand(nh),
                        torch.randn(b, s, n), torch.randn(b, s, n))


SITES = {"cross_entropy and its gradient": _lm_loss_and_grad,
         "resnet loss and the LM eval": _resnet_loss_and_eval,
         "scoring and K1-K4's plain scoring": _scores, "theory": _theory,
         "sample_clients": _sampler, "ssd_recurrence": _recurrence}


@pytest.mark.parametrize("site", list(SITES))
def test_moved_call_sites_dispatch_no_vml_op_on_the_cpu(site):
    rec = Record()
    with rec:
        SITES[site]()
    assert not rec.ops & VML_OPS, sorted(rec.ops & VML_OPS)
    assert rec.ops, "nothing was recorded"


def test_log1p_within_one_ulp_of_f64():
    tiny = np.float32([0.0, 1e-30, 2.0 ** -149, 2.0 ** -126, 2.0 ** -30, 2.0 ** -25,
                       5.9e-8, 2.0 ** -24, 1.1e-7])
    grid = np.concatenate([tiny, -tiny[1:],
                           np.linspace(0.0, 100.0, 100_001, dtype=np.float32),   # staleness
                           np.geomspace(1e-12, 1e30, 50_001).astype(np.float32),
                           -np.geomspace(1e-12, 0.999, 20_001).astype(np.float32)])
    x = torch.from_numpy(grid)
    got = _math.log1p(x)
    want = torch.log1p(x.double()).float()
    assert got.dtype == torch.float32
    assert int(ulps(got, want).max()) <= 1
    assert int(ulps(got, torch.log1p(x)).max()) <= 1
    # Exact where log1p(x) rounds to x, and the limits.
    assert torch.equal(_math.log1p(torch.from_numpy(tiny[:6])), torch.from_numpy(tiny[:6]))
    edge = _math.log1p(torch.tensor([-1.0, torch.inf, -2.0, torch.nan]))
    assert edge[0] == -torch.inf and edge[1] == torch.inf
    assert bool(torch.isnan(edge[2:]).all())


def test_logsumexp_within_one_ulp_of_f64_and_the_losses_of_torch():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 1000, generator=gen) * 8
    x[3, 500:] = torch.finfo(torch.float32).min          # padded vocab columns
    x[5] = -torch.inf
    got = _math.logsumexp(x, dim=-1)
    want = torch.logsumexp(x.double(), dim=-1).float()
    fin = torch.isfinite(want)
    assert int(ulps(got[fin], want[fin]).max()) <= 1
    assert got[5] == -torch.inf
    # The losses: within 1 ulp of the f32 loss through torch.logsumexp.
    logits = torch.randn(8, 32, 512, generator=gen) * 4
    labels = torch.randint(0, 512, (8, 32), generator=gen)
    mask = torch.rand(8, 32, generator=gen) > 0.3
    for m in (None, mask):
        lf = logits.float()
        nll = torch.logsumexp(lf, -1) - torch.gather(lf, -1, labels[..., None])[..., 0]
        before = nll.mean() if m is None else (nll * m).sum() / m.sum()
        assert int(ulps(layers.cross_entropy(logits, labels, m)[None], before[None])[0]) <= 1


def test_logsumexp_gradient_is_the_softmax_and_it_vmaps():
    x = torch.randn(3, 7, 50, requires_grad=True)
    _math.logsumexp(x, dim=-1).sum().backward()
    torch.testing.assert_close(x.grad, torch.softmax(x.detach(), -1), rtol=1e-6, atol=1e-7)
    got = torch.func.vmap(lambda r: _math.logsumexp(r, dim=-1))(x.detach())
    assert int(ulps(got, torch.logsumexp(x.detach().double(), -1).float()).max()) <= 1


_CHILD = textwrap.dedent(r"""
    import json, sys
    import torch
    from repro_torch.kernels import _math
    from repro_torch.models import layers

    seed = int(sys.argv[1])
    gen = torch.Generator().manual_seed(seed)
    threads = torch.get_num_threads()
    logits = torch.randn(64, 64, 512, generator=gen) * 4
    labels = torch.randint(0, 512, (64, 64), generator=gen)
    stale = torch.rand(1 << 20, generator=gen) * 100
    e = -20 * torch.rand(1 << 20, generator=gen)
    p = torch.rand(1 << 20, generator=gen)
    first = {"logsumexp": _math.logsumexp(logits, dim=-1), "log1p": _math.log1p(stale),
             "exp": _math.exp(e), "log": _math.log(p),
             "cross_entropy": layers.cross_entropy(logits, labels)[None]}
    # The loss as it was, through torch.logsumexp, on one thread.
    torch.set_num_threads(1)
    nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, labels[..., None])[..., 0]
    ld = logits.double()
    want = {"logsumexp": torch.logsumexp(ld, -1).float(),
            "log1p": torch.log1p(stale.double()).float(), "exp": torch.exp(e.double()).float(),
            "log": torch.log(p.double()).float(), "cross_entropy": nll.mean()[None]}

    def ulps(a, b):
        line = lambda t: torch.where(t.view(torch.int32) < 0,
                                     -(t.view(torch.int32) & 0x7FFFFFFF),
                                     t.view(torch.int32)).long()
        return int((line(a) - line(b)).abs().max())

    print(json.dumps({"threads": threads,
                      "ulps": {n: ulps(first[n], want[n]) for n in first}}))
""")


def run_child(seed: int) -> dict:
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-c", _CHILD, str(seed)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("seeds", [(1,), (2, 3, 4)], ids=["alone", "three-at-once"])
def test_first_multithreaded_calls_within_one_ulp_of_f64(seeds):
    with ThreadPoolExecutor(len(seeds)) as pool:
        outs = list(pool.map(run_child, seeds))
    bad = {s: {n: u for n, u in o["ulps"].items() if u > 1}
           for s, o in zip(seeds, outs)}
    assert not any(bad.values()), f"on {outs[0]['threads']} threads: {json.dumps(bad)}"
