"""K5's CPU path under vmap∘grad: the multi-threaded result against the
one-thread result, each in a fresh process, with no card involved.

The first multi-threaded CPU vmap∘grad of a process through K5's plain
path could put one intra-op thread's share of the folded batch 1.3e-4 off
the one-thread result (1 in 20-60 processes on an H100's host, and in the
suite's own CPU-only run). The op recorder (``--trace``) caught the
moving op: ``torch.exp`` of the forward's scores, which for a CPU float
tensor runs MKL's vector math library (VML) on each thread's share. The
first VML call of a process, made on several threads at once, can compute
one share at ~1.5e-4 relative accuracy; ``--torch-only`` shows it with
torch alone. The plain path now takes exp and log without VML
(``kernels/_math.exp``), so this test holds it to the one-thread
result. Each child process starts fresh, computes the vmap∘grad first on
the default thread count, then on one thread, then the multi-threaded call
again, and reports the (client, batch, KV head) groups where the first call
is over the card test's tolerance.

The test runs four seeds one process at a time and six seeds in six
processes at once, as the suite's six xdist workers load the host. Run as a
script to sample many processes, ``--parallel`` of them at a time::

    PYTHONPATH=src python tests/test_torch_flash_threads.py --procs 64 --parallel 6 \
        [--card none|touch|grad] [--trace [OP ...]] [--torch-only]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import pytest

_CHILD = textwrap.dedent(r"""
    import json, sys
    import torch
    from repro_torch.kernels import ops

    seed, card = int(sys.argv[1]), sys.argv[2]
    trace = sys.argv[3].split(",") if sys.argv[3] else None   # aten op names; "all": every op
    n, (b, s, t, h, kvh, d) = 4, (8, 32, 32, 14, 2, 64)
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen).unsqueeze(0).expand(n, *shape).contiguous()
               for shape in ((b, s, h, d), (b, t, kvh, d), (b, t, kvh, d)))
    w = torch.randn(q.shape, generator=gen)

    def loss(q, k, v, w):
        return (ops.flash_mha(q, k, v, causal=True) * w).sum()

    grad = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))
    if card == "touch":     # the card in use before the CPU call
        torch.ones(1, device="cuda").sum().item()
    elif card == "grad":    # the card test's order: K5's vmap∘grad on the card first
        [g.sum().item() for g in grad(*(x.cuda() for x in (q, k, v, w)))]
    threads = torch.get_num_threads()
    if trace:   # record the traced aten ops of the first call with their inputs and outputs
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves, tree_map

        snap = lambda x: x.clone() if isinstance(x, torch.Tensor) else x

        class Record(TorchDispatchMode):
            # Inputs are kept by reference (copied only for an op that writes
            # in place), so the recorder moves little memory of its own.
            calls, mutable = [], set()

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if "all" not in trace and func.overloadpacket.__name__ not in trace:
                    return func(*args, **(kwargs or {}))
                if func._schema.is_mutable:
                    self.mutable.add(str(func))
                    before = tree_map(snap, (args, kwargs or {}))
                else:
                    before = (args, kwargs or {})
                result = func(*args, **(kwargs or {}))
                self.calls.append((func, before, tree_map(snap, result)))
                return result

        with Record():
            first = grad(q, k, v, w)
    else:
        first = grad(q, k, v, w)
    torch.set_num_threads(1)
    one = grad(q, k, v, w)
    out = {"threads": threads, "grads": {}}
    if trace:   # each op again on one thread, on its recorded inputs
        out["ops"], out["ops_differ"] = len(Record.calls), []
        out["mutable_ops"] = sorted(Record.mutable)
        for i, (func, (a, kw), result) in enumerate(Record.calls):
            redo = func(*tree_map(snap, a), **tree_map(snap, kw))
            for x, y in zip(tree_leaves(result), tree_leaves(redo)):
                if isinstance(x, torch.Tensor) and x.is_floating_point() \
                        and not torch.equal(x, y):
                    out["ops_differ"].append({
                        "index": i, "op": str(func), "max_diff": float((x - y).abs().max()),
                        "shapes": [list(z.shape) for z in tree_leaves(a)
                                   if isinstance(z, torch.Tensor)],
                        "strides": [list(z.stride()) for z in tree_leaves(a)
                                    if isinstance(z, torch.Tensor)]})
    torch.set_num_threads(threads)
    again = grad(q, k, v, w)
    for name, f, o, a in zip("qkv", first, one, again):
        bad = (f - o).abs() > 1e-5 + 1e-5 * o.abs()
        heads = bad.any(2).any(-1)          # (client, batch, head)
        groups = heads.reshape(n, b, kvh, -1).any(-1) if name == "q" else heads
        out["grads"][name] = {
            "max_first_vs_one": float((f - o).abs().max()),
            "max_again_vs_one": float((a - o).abs().max()),
            "n_over": int(bad.sum()),
            "groups": groups.nonzero().tolist()[:16]}
    print(json.dumps(out))
""")

# torch alone: the op the recorder caught moving (the forward's exp over the
# folded scores, (32, 2, 7, 32, 32) f32), as the first op of a fresh process,
# first on the default threads, then on one thread. torch.exp of a CPU float
# tensor runs MKL's vector math (VML) on each intra-op thread's share. Any
# bit that moves is reported, with the shares (of 8) it lies in.
_CHILD_VML = textwrap.dedent(r"""
    import json, sys
    import torch

    seed, card = int(sys.argv[1]), sys.argv[2]
    gen = torch.Generator().manual_seed(seed)
    x = -20 * torch.rand((32, 2, 7, 32, 32), generator=gen)
    if card == "touch":
        torch.ones(1, device="cuda").sum().item()
    threads = torch.get_num_threads()
    first = torch.exp(x)
    torch.set_num_threads(1)
    one = torch.exp(x)
    moved = (first != one).flatten()
    shares = sorted({int(i) * threads // moved.numel() for i in moved.nonzero().flatten()})
    print(json.dumps({"threads": threads, "moved": int(moved.sum()),
                      "max_rel": float(((first - one).abs() / one).max()), "shares": shares,
                      "grads": {"exp": {"n_over": int(moved.sum())}}}))
""")


def run_child(seed: int, card: str = "none", trace: tuple = (), torch_only: bool = False
              ) -> dict:
    """One fresh interpreter: K5's vmap∘grad on the CPU, first on the
    default threads, then on one thread, then again on the default. With
    ``card="touch"`` the card runs one small op first, with ``"grad"`` the
    same vmap∘grad; with ``"none"`` no card is visible. With ``trace`` (aten
    op names such as ``"bmm"``, or ``"all"``) the first call's ops of those
    names are recorded and each is run again on one thread on its recorded
    inputs; ``ops_differ`` lists those whose output moved. With
    ``torch_only`` the child runs the op that moved alone, ``torch.exp`` of
    the forward's scores, with no port code."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    if card == "none":
        env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-c", _CHILD_VML if torch_only else _CHILD,
                          str(seed), card, ",".join(trace)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def run_children(seeds, parallel: int = 1, **kwargs) -> list:
    """``run_child`` for each seed, ``parallel`` processes at a time."""
    with ThreadPoolExecutor(parallel) as pool:
        return list(pool.map(lambda seed: run_child(seed, **kwargs), seeds))


@pytest.mark.parametrize("seeds", [(2,), (3,), (5,), (7,), (11, 13, 17, 19, 23, 29)],
                         ids=["2", "3", "5", "7", "six-at-once"])
def test_first_multithreaded_vmap_grad_is_the_one_thread_result(seeds):
    """The first multi-threaded CPU vmap∘grad of a fresh process agrees with
    the one-thread result to the card test's rtol = atol = 1e-5, in one
    process alone and in six processes at once."""
    outs = run_children(seeds, parallel=len(seeds))
    bad = {seed: {name: g for name, g in out["grads"].items() if g["n_over"]}
           for seed, out in zip(seeds, outs)}
    bad = {seed: b for seed, b in bad.items() if b}
    assert not bad, f"on {outs[0]['threads']} threads: {json.dumps(bad)}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=16)
    ap.add_argument("--card", choices=("none", "touch", "grad"), default="none",
                    help="before the CPU calls: no card visible, one small op on the "
                         "card, or the same vmap∘grad on the card")
    ap.add_argument("--parallel", type=int, default=1,
                    help="child processes at a time")
    ap.add_argument("--trace", nargs="*", metavar="OP",
                    help="record the first call's aten ops (of these names; all without "
                         "one) and run each again on one thread")
    ap.add_argument("--torch-only", action="store_true",
                    help="torch.exp of K5's scores alone, as a process's first op; no port code")
    args = ap.parse_args()
    trace = () if args.trace is None else tuple(args.trace) or ("all",)
    failed = 0
    with ThreadPoolExecutor(args.parallel) as pool:
        outs = pool.map(lambda seed: run_child(seed, card=args.card, trace=trace,
                                                  torch_only=args.torch_only),
                        range(args.procs))
        for seed, out in enumerate(outs):
            over = {n: g for n, g in out["grads"].items() if g["n_over"]}
            failed += bool(over)
            print(json.dumps({"seed": seed, **out}), flush=True)
    print(f"{failed} of {args.procs} processes ({args.parallel} at a time, card "
          f"{args.card}): first multi-threaded call over the tolerance "
          f"against one thread", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
