"""Parameter exchange with the reference JAX package, through numpy.

``params_from_jax`` turns a reference parameter pytree — nested dicts of
leaf arrays, as ``jax.device_get`` or ``np.asarray`` gives them, for one
worker or worker-stacked ``[W, ...]`` — into the port's flat dict of
tensors named by the ``"/"``-joined paths (``"blocks/attn/wq"``; the
MLP's leaves are top-level, ``"w1"``), in sorted-name order: the
adapters' leaf order, which is the reference's ``jax.tree`` order. A
leaf whose array type is named ``bfloat16`` (the reference's bf16
leaves) crosses as a bf16 tensor: it is upcast to f32 numpy, which is
exact, and cast back in torch, also exact — no ``ml_dtypes`` on this
side. ``params_to_numpy`` is its inverse, back to nested dicts of f32
numpy arrays (exact for bf16 leaves; the reference casts them back). The
tests hand the reference's ``adapter.init(PRNGKey(seed))`` to the port's
engines (``init_params=``) and compare trajectories from identical
weights. ``slot_pieces`` cuts whole leaves into a model axis's slot
pieces by the spec rules (``runtime/sharding.leaf_splits`` /
``cut_leaf``, as the round step lays them out), so one init from the
reference feeds both packages on such a mesh. Nothing here imports
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.runtime import sharding


def _flat_items(tree, prefix: str = ""):
    for k in sorted(tree, key=str):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flat_items(v, name + "/")
        else:
            yield name, v


_NARROW = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _leaf_tensor(v) -> torch.Tensor:
    arr = np.asarray(v)
    t = torch.tensor(np.asarray(arr, np.float32))
    return t.to(_NARROW.get(arr.dtype.name, torch.float32))


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Nested {name: array-like} -> {"/"-joined name: CPU tensor} (a
    copy), in sorted-name order: bf16 for a ``bfloat16`` leaf, f16 for a
    ``float16`` one, f32 otherwise."""
    return {name: _leaf_tensor(v) for name, v in _flat_items(tree)}


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


def slot_pieces(params: dict, cfg, mesh, *, lead: int = 0) -> list[dict]:
    """{name: whole leaf} (``lead`` leading dims, e.g. 1 for a
    worker-stacked tree) -> each model-axis slot's {name: piece} of
    ``mesh`` (views; a leaf the rules keep whole is every slot's)."""
    shapes = {k: tuple(v.shape[lead:]) for k, v in params.items()}
    m = sharding.model_extent(cfg, mesh)
    splits = sharding.leaf_splits(cfg, mesh, shapes)
    out: list[dict] = [{} for _ in range(m)]
    for k, v in params.items():
        for j, piece in enumerate(sharding.cut_leaf(v, splits[k], m, lead)):
            out[j][k] = piece
    return out
