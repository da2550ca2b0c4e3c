"""Federated LLM fine-tuning: HeteRo-Select scheduling a language-model
federation, the port of the reference's ``examples/federated_llm.py``.

The control plane is model-agnostic: the same round engine drives an LM
data plane (per-client bigram "dialects") on the smoke variant of any LM
architecture, e.g. the dense qwen2 (the default), the mamba2 SSM, the kimi-k2
MoE or the zamba2 hybrid (Mamba2 blocks through K7 and a shared attention
block through K5). ``FLResult.metric_name`` reports the LM eval metric as
exp(-loss), not accuracy.

    PYTHONPATH=src python -m repro_torch.examples.federated_llm [--rounds 8] \\
        [--arch zamba2-7b] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import FedConfig, get_config, smoke_variant
from repro_torch.data import make_lm_data
from repro_torch.fed import FederatedSpec, FLResult
from repro_torch.models import build_model

LM_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def main(argv: Optional[Sequence[str]] = None) -> FLResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_variant(get_config(args.arch))
    if cfg.family not in LM_FAMILIES:
        ap.error(f"--arch {args.arch} is a '{cfg.family}' model; the LM federation "
                 f"takes the {', '.join(LM_FAMILIES)} families")
    fed = FedConfig(num_clients=8, participation=0.5, rounds=args.rounds,
                    local_epochs=1, local_batch=8, lr=0.05, mu=0.1, seed=0)
    data = make_lm_data(fed, vocab=cfg.vocab_size, seq_len=32)
    model = build_model(cfg)

    print(f"arch={cfg.name} (reduced)  clients={fed.num_clients}  "
          f"dialect JS: {np.round(data.label_js, 3)}", flush=True)
    res = FederatedSpec(model, fed, data, selector="heterosel", steps_per_round=3,
                        verbose=True, device=args.device).build().run()
    print(f"\nper-round eval {res.metric_name}:", np.round(res.accuracy, 4))
    print("train loss:", np.round(res.train_loss, 3), flush=True)
    return res


if __name__ == "__main__":
    main()
