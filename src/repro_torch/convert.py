"""Carry weights between the JAX reference's params pytree and the port.

The reference keeps params as a nested dict of arrays; the port keeps a
flat dict keyed by dotted paths of the same names (``stem``,
``block3.conv1``, …, ``fc_w`` for the resnet; ``embed.tok_embed``,
``layers.attn.wq``, …, ``final_norm`` for the LM families). The resnet's
conv kernels, and only they, change layout: HWIO there, OIHW here. Every
other leaf, the stacked 4-D attention and expert weights included, is
carried as it is. Both directions copy values bitwise; bf16 leaves travel
as their 16-bit patterns (numpy's bf16 is ``ml_dtypes.bfloat16``, imported
only when such a leaf goes back to the reference layout).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)
# Leaf names of the resnet's conv kernels (models/resnet.py).
_CONV_LEAVES = frozenset({"stem", "conv1", "conv2", "proj"})


def _is_conv(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in _CONV_LEAVES


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + ".")
        else:
            yield name, np.asarray(v)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (reference layout) → flat torch dict."""
    out = {}
    for name, a in _flatten(tree):
        if _is_conv(name):
            a = a.transpose(_HWIO_TO_OIHW)
        a = np.array(a, order="C")  # a writable copy
        if a.dtype.name == "bfloat16":
            out[name] = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(a)
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat torch dict → nested dict of numpy arrays in the reference layout."""
    tree: Dict[str, Any] = {}
    for name, t in params.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            a = t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        else:
            a = t.numpy()
        if _is_conv(name):
            a = np.ascontiguousarray(a.transpose(_OIHW_TO_HWIO))
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


_EXPERT_LEAVES = ("layers.moe.w_gate", "layers.moe.w_up", "layers.moe.w_down")


def expert_share_params(params: Dict[str, torch.Tensor], *, experts_here: int,
                        first_expert: int = 0) -> Dict[str, torch.Tensor]:
    """An MoE model's params with every expert's weights cut to one device's
    share, experts [first_expert, first_expert + experts_here) of the stacked
    (L, E, …) expert leaves; the router and every other leaf as they are."""
    share = slice(first_expert, first_expert + experts_here)
    return {name: p[:, share].clone() if name in _EXPERT_LEAVES else p
            for name, p in params.items()}
