"""Production-features demo, the port of the reference's
``examples/production_features.py``: the paper's declared future work,
running.

One federation, five spec configurations of the composable round engine:
  1. paper-faithful Algorithm 1 (baseline),
  2. + int8 update compression, composed with the *batched* executor
     (stateless codec ⇒ vectorized over the client stack),
  3. + top-k sparsification with error feedback (sequential executor —
     the codec owns per-client host residuals),
  4. + client churn (A5 relaxed) + adaptive μ (Lemma A.4 online, a hook),
  5. + server momentum (FedAvgM aggregator).

    PYTHONPATH=src python -m repro_torch.examples.production_features \\
        [--rounds 12] [--steps 4] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import FedConfig, get_config, smoke_variant
from repro_torch.data import make_vision_data
from repro_torch.fed import AvailabilityTrace, FederatedSpec, FLResult
from repro_torch.models import build_model


def run(rounds: int = 12, device: str = "cuda", steps: int = 4) -> dict[str, FLResult]:
    """The five configurations' results, by name (``steps`` local steps a
    round)."""
    fed = FedConfig(num_clients=10, participation=0.5, rounds=rounds,
                    local_epochs=2, local_batch=16, lr=0.3, mu=0.1,
                    dirichlet_alpha=0.1, seed=0)
    data = make_vision_data(fed, train_per_class=48, test_per_class=16, noise=0.3)
    model = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8))
    runs = {
        "baseline": dict(),
        "int8 (batched)": dict(compression="int8", executor="batched"),
        "topk10%+EF (seq)": dict(compression="topk", topk_frac=0.1,
                                 executor="sequential"),
        "churn+adaptive-mu": dict(
            availability=AvailabilityTrace(fed.num_clients, seed=2).masks(fed.rounds),
            hooks=["adaptive_mu"]),
        "fedavgm": dict(aggregator="fedavgm"),
    }
    return {name: FederatedSpec(model, fed, data, selector="heterosel",
                                steps_per_round=steps, device=device, **kw).build().run()
            for name, kw in runs.items()}


def main(argv: Optional[Sequence[str]] = None) -> dict[str, FLResult]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--steps", type=int, default=4, help="local steps a round")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    results = run(args.rounds, args.device, args.steps)
    print(f"{'config':20s} {'peak':>6s} {'final':>6s} {'wire-compression':>17s}  mu trace")
    for name, res in results.items():
        ratio = res.raw_bytes / res.wire_bytes if res.wire_bytes else 1.0
        mu = (np.round(res.mu_history, 3).tolist()[:5]
              if res.mu_history is not None else "-")
        print(f"{name:20s} {res.peak_acc:6.3f} {res.final_acc:6.3f} "
              f"{ratio:16.1f}x  {mu}")
    return results


if __name__ == "__main__":
    main()
