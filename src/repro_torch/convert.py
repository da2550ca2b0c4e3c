"""Carry weights between the JAX reference's params pytree and the port.

The reference keeps ResNet params as a nested dict of arrays with HWIO
conv kernels; the port keeps a flat dict keyed by dotted paths of the same
names (``stem``, ``gn_stem.scale``, ``block3.conv1``, …, ``fc_w``,
``fc_b``) with OIHW conv weights. Both directions copy values bitwise.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


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
        if a.ndim == 4:
            a = a.transpose(_HWIO_TO_OIHW)
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat torch dict → nested dict of numpy arrays in the reference layout."""
    tree: Dict[str, Any] = {}
    for name, t in params.items():
        a = t.detach().cpu().numpy()
        if a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(_OIHW_TO_HWIO))
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree
