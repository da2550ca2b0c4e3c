"""Quickstart: HeteRo-Select federated training, the port of the reference's
``examples/quickstart.py``.

Runs the paper's Algorithm 1 on a synthetic non-IID image federation (12
clients, Dirichlet α = 0.1, 50 % participation, FedProx μ = 0.1) through
the round engine and prints the paper's metrics: peak / final / stable
accuracy and the stability drop.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--rounds 20] \\
        [--selector NAME] [--executor batched|sequential] \\
        [--aggregator fedavg|fedavg_weighted|fedavgm|fedbuff] \\
        [--round-policy sync|async] [--deadline D] [--over-select EPS] \\
        [--straggler-factor F] [--topology flat|hierarchical] [--edges E] \\
        [--device cuda|cpu]

Every flag of the reference's script is taken. ``--round-policy async``
switches to event-driven asynchronous rounds on a virtual wall clock
(deadline-closed, over-selected, staleness-weighted buffered aggregation);
``--straggler-factor 10`` makes every fifth client 10× slower.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import FedConfig, get_config, smoke_variant
from repro_torch.core.selection import SELECTORS
from repro_torch.data import make_vision_data
from repro_torch.fed import AsyncConfig, FederatedSpec, FLResult
from repro_torch.models import build_model


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--selector", default="heterosel", metavar="NAME",
                    help=f"one of {', '.join(SELECTORS)}, or filtered:<base>")
    ap.add_argument("--executor", "--client-execution", dest="executor",
                    default=None, choices=["batched", "sequential"],
                    help="override FedConfig.client_execution")
    ap.add_argument("--aggregator", default="fedavg",
                    choices=["fedavg", "fedavg_weighted", "fedavgm", "fedbuff"])
    ap.add_argument("--round-policy", default="sync", choices=["sync", "async"])
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="async round deadline (0 = wait for the full cohort)")
    ap.add_argument("--over-select", type=float, default=0.0,
                    help="async over-selection fraction ε")
    ap.add_argument("--straggler-factor", type=float, default=1.0,
                    help="every 5th client is this many times slower")
    ap.add_argument("--topology", default="flat", choices=["flat", "hierarchical"],
                    help="two-tier client→edge→cloud rounds")
    ap.add_argument("--edges", type=int, default=0,
                    help="hierarchical: number of edge groups E (default 4)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> FLResult:
    ap = parser()
    args = ap.parse_args(argv)
    if args.edges and args.topology != "hierarchical":
        ap.error("--edges only takes effect with --topology hierarchical "
                 "(flat rounds have no edge tier)")
    edge_count = (args.edges or 4) if args.topology == "hierarchical" else 0
    fed = FedConfig(num_clients=12, participation=0.5, rounds=args.rounds,
                    local_epochs=2, local_batch=16, lr=0.3, mu=0.1,
                    dirichlet_alpha=0.1, seed=0, topology=args.topology,
                    edge_count=edge_count)
    data = make_vision_data(fed, train_per_class=48, test_per_class=16, noise=0.3)
    model = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8))

    system = None
    async_cfg = None
    if args.straggler_factor != 1.0:
        if args.round_policy != "async":
            ap.error("--straggler-factor only takes effect with "
                     "--round-policy async (sync rounds have no clock)")
        system = np.ones(fed.num_clients)
        system[::5] = args.straggler_factor
    if args.round_policy == "async":
        async_cfg = AsyncConfig(
            deadline=args.deadline if args.deadline > 0 else math.inf,
            over_select_frac=args.over_select)

    print(f"selector={args.selector}  clients={fed.num_clients}  "
          f"m={fed.num_selected}/round  mu={fed.mu}  policy={args.round_policy}"
          + (f"  topology=hierarchical E={fed.edge_count}"
             if fed.topology == "hierarchical" else ""), flush=True)
    spec = FederatedSpec(model, fed, data, selector=args.selector, steps_per_round=4,
                         executor=args.executor, aggregator=args.aggregator, verbose=True,
                         round_policy=args.round_policy, async_cfg=async_cfg,
                         system=system, device=args.device)
    res = spec.build().run()
    print(f"\n== paper metrics (eval metric: {res.metric_name}) ==")
    for k, v in res.summary().items():
        print(f"  {k:16s} {v:.4f}")
    print(f"  selection counts: {res.selection_counts.tolist()}")
    if res.wall_clock is not None and len(res.wall_clock):
        print(f"  simulated wall-clock: {res.wall_clock[-1]:.2f} units, "
              f"mean update staleness {float(res.round_staleness.mean()):.2f}")
    if res.cloud_uploads is not None:
        print(f"  edge→cloud uploads: {int(res.cloud_uploads.sum())} "
              f"aggregates (flat would ship "
              f"{fed.num_selected * fed.rounds} client updates)", flush=True)
    return res


if __name__ == "__main__":
    main()
