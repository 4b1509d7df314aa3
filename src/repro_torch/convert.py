"""Parameter exchange with the reference JAX package, through numpy.

``params_from_jax`` turns a reference parameter pytree — nested dicts of
leaf arrays, as ``jax.device_get`` or ``np.asarray`` gives them, for one
worker or worker-stacked ``[W, ...]`` — into the port's flat dict of f32
tensors named by the ``"/"``-joined paths (``"blocks/attn/wq"``; the
MLP's leaves are top-level, ``"w1"``), in sorted-name order: the
adapters' leaf order, which is the reference's ``jax.tree`` order.
``params_to_numpy`` is its inverse, back to nested dicts of numpy
arrays. The tests hand the reference's ``adapter.init(PRNGKey(seed))``
to the port's engines (``init_params=``) and compare trajectories from
identical weights. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _flat_items(tree, prefix: str = ""):
    for k in sorted(tree, key=str):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flat_items(v, name + "/")
        else:
            yield name, v


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Nested {name: array-like} -> {"/"-joined name: f32 CPU tensor}
    (a copy), in sorted-name order."""
    return {name: torch.tensor(np.asarray(v, np.float32))
            for name, v in _flat_items(tree)}


def params_to_numpy(params) -> dict:
    """{"/"-joined name: tensor} -> nested {name: f32 numpy array} on the
    host."""
    out: dict = {}
    for name, v in params.items():
        *parents, leaf = name.split("/")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = v.detach().to("cpu", torch.float32).numpy()
    return out
