"""The paper's Table I experiment in the port: five selection policies on
one non-IID federation, each with its peak, final and stable accuracy,
stability drop and the spread of its selection counts (Figs 5/6).
Counterpart of the reference's ``examples/paper_reproduction.py``.

    PYTHONPATH=src python -m repro_torch.examples.paper_reproduction \\
        [--rounds 40] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import FedConfig, get_config, smoke_variant
from repro_torch.data import make_vision_data
from repro_torch.fed import FederatedSpec, FLResult
from repro_torch.models import build_model

METHODS = ("heterosel", "heterosel_mult", "oort", "power_of_choice", "random")


def run_methods(model: Any, fed: FedConfig, data: Any, *, device="cuda",
                methods: Sequence[str] = METHODS, steps_per_round: int = 4,
                noise: Optional[Callable[[str], Any]] = None,
                init_params: Optional[Dict[str, Any]] = None) -> Dict[str, FLResult]:
    """One run per selector on the same federation and initial weights.
    ``noise(name)`` gives a selector's ``FederatedSpec.noise`` (None: drawn
    from ``fed.seed``)."""
    return {name: FederatedSpec(
        model, fed, data, selector=name, steps_per_round=steps_per_round,
        device=device, noise=noise(name) if noise else None,
        init_params=init_params).build().run() for name in methods}


def report(results: Dict[str, FLResult]) -> None:
    for name, res in results.items():
        s = res.labeled_summary()
        print(f"{name:16s} " + "  ".join(f"{k}={v:.4f}" for k, v in s.items())
              + f"  counts={res.selection_counts.tolist()}", flush=True)
    print("stability drop, lowest first:",
          sorted(results, key=lambda n: results[n].stability_drop), flush=True)


def main(device: str | torch.device = "cuda", rounds: int = 40) -> Dict[str, FLResult]:
    """The reference example's federation: K = 12, m = 6, Dirichlet
    α = 0.1, the d_model 8 ResNet-18, 4 local steps of batch 16, lr 0.3."""
    fed = FedConfig(num_clients=12, participation=0.5, rounds=rounds, local_epochs=2,
                    local_batch=16, lr=0.3, mu=0.1, dirichlet_alpha=0.1, seed=0)
    data = make_vision_data(fed, train_per_class=64, test_per_class=16, noise=0.4)
    model = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8))
    print("label JS divergence per client:", np.round(data.label_js, 3), flush=True)
    results = run_methods(model, fed, data, device=device)
    report(results)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.device, args.rounds)
