"""Serve the federated global model: batched autoregressive decoding with a
cache, through the shared ``repro_torch.serve.generate`` decode path (the
same loop ``launch.serve`` and the continuous-batching ``ModelServer`` run);
the port of the reference's ``examples/serve_global_model.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_global_model \\
        [--tokens 16] [--arch yi-9b] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import generate
from repro_torch.serve.traffic import GumbelSource


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_variant(get_config(args.arch))
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))

    b = args.batch
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(b, 4)).astype(np.int32)
    gen = generate(model, params, prompt, args.tokens, GumbelSource(2))
    print(f"arch={cfg.name} (reduced)  batch={b}")
    print("prompt:\n", prompt)
    print("generated token ids:\n", gen)
    return gen


if __name__ == "__main__":
    main()
