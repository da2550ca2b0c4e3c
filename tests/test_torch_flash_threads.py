"""K5's CPU path under vmap∘grad: the multi-threaded result against the
one-thread result, each in a fresh process, with no card involved.

In pytest processes on the host of an H100 (torch 2.11.0), the first
multi-threaded CPU vmap∘grad through K5's plain path put one intra-op
thread's share of the folded batch 1.3e-4 off the one-thread result in 3 of
16 processes. This file asks the same question on the CPU alone. Each child
process starts fresh, computes the vmap∘grad first on the default thread
count (its first call, as in the failing processes), then on one thread,
then the multi-threaded call again, and reports the (client, batch, KV head)
groups where the first call is over the card test's tolerance.

Run as a script to sample many processes::

    PYTHONPATH=src python tests/test_torch_flash_threads.py --procs 32 [--card touch] [--trace]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap

import pytest

_CHILD = textwrap.dedent(r"""
    import json, sys
    import torch
    from repro_torch.kernels import ops

    seed, card, trace = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "1"
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
    if trace:   # record every aten op of the first call with its inputs and outputs
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves, tree_map

        snap = lambda x: x.clone() if isinstance(x, torch.Tensor) else x

        class Record(TorchDispatchMode):
            calls = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                before = tree_map(snap, (args, kwargs or {}))
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


def run_child(seed: int, card: str = "none", trace: bool = False) -> dict:
    """One fresh interpreter: K5's vmap∘grad on the CPU, first on the
    default threads, then on one thread, then again on the default. With
    ``card="touch"`` the card runs one small op first, with ``"grad"`` the
    same vmap∘grad; with ``"none"`` no card is visible. With ``trace`` the
    first call's aten ops are recorded and each is run again on one thread
    on its recorded inputs; ``ops_differ`` lists those whose output moved."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    if card == "none":
        env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-c", _CHILD, str(seed), card, str(int(trace))],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("seed", [2, 3, 5, 7])
def test_first_multithreaded_vmap_grad_is_the_one_thread_result(seed):
    """The first multi-threaded CPU vmap∘grad of a fresh process agrees with
    the one-thread result to the card test's rtol = atol = 1e-5."""
    out = run_child(seed)
    bad = {name: g for name, g in out["grads"].items() if g["n_over"]}
    assert not bad, f"on {out['threads']} threads: {json.dumps(bad)}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=16)
    ap.add_argument("--card", choices=("none", "touch", "grad"), default="none",
                    help="before the CPU calls: no card visible, one small op on the "
                         "card, or the same vmap∘grad on the card")
    ap.add_argument("--trace", action="store_true",
                    help="record the first call's aten ops and run each again on one thread")
    args = ap.parse_args()
    failed = 0
    for seed in range(args.procs):
        out = run_child(seed, card=args.card, trace=args.trace)
        over = {n: g for n, g in out["grads"].items() if g["n_over"]}
        failed += bool(over)
        print(json.dumps({"seed": seed, **out}), flush=True)
    print(f"{failed} of {args.procs} processes: first multi-threaded call over the "
          f"tolerance against one thread", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
