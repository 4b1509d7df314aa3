"""Checkpoint store: the port of ``repro.checkpoint.store``, on the same
on-disk format, so that a checkpoint either package writes loads in the
other under ``convert``'s key map.

- Atomic: write to ``<dir>/tmp.<step>``, fsync, rename to
  ``<dir>/step_<n>`` (eight digits).
- One npz entry per leaf, keyed by its path: nested dict keys joined by
  ``"/"`` (the reference's tree paths), or a flat dict's own ``"/"``
  names, which are the same keys. A worker-stacked ``[W, ...]`` leaf
  keeps its leading worker axis, so restore can re-shard it onto another
  worker count (``elastic_reshard``).
- Dtype fidelity: npz stores native numpy dtypes only, so a bf16 leaf is
  stored as its bits, a uint16 view (``tensor.view(torch.int16)``, read
  as numpy ``uint16``; no ``ml_dtypes``), with every leaf's dtype name in
  ``meta.json`` under ``_leaf_dtypes``; load restores the view, bit for
  bit, with dtype and shape.
- Retention: ``CheckpointManager`` keeps the most recent ``keep``
  checkpoints.

Leaves go in as tensors, numpy arrays or Python scalars and come back
as CPU tensors.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict[str, object]:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree, key=str):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf -> (an array npz can store, the leaf's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        if t.dtype.is_floating_point and t.element_size() == 1:
            return t.view(torch.uint8).numpy(), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    if arr.dtype.kind in "biufc":
        return arr, arr.dtype.name
    raise TypeError(f"cannot store a leaf of dtype {arr.dtype.name} "
                    "without its library; pass a torch tensor")


def _to_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """A stored array and its recorded dtype name -> a CPU tensor of
    that dtype (the bits of a uint view reinterpreted)."""
    if arr.dtype.name == name:
        return torch.from_numpy(np.ascontiguousarray(arr))
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype) or \
            torch.empty((), dtype=dt).element_size() != arr.dtype.itemsize:
        raise ValueError(f"checkpoint leaf of dtype {name!r} stored as "
                         f"{arr.dtype.name}: no torch dtype restores it")
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[arr.dtype.itemsize]
    bits = np.ascontiguousarray(arr).view(f"int{8 * arr.dtype.itemsize}")
    return torch.from_numpy(bits).view(signed).view(dt)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.dtype(leaf.dtype).name


def _unflatten_into(template, flat: dict[str, torch.Tensor],
                    prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    t = flat[key]
    tshape = getattr(template, "shape", None)
    if tshape is not None:
        # elastic restore re-shards the leading (worker) dim, so only the
        # per-replica trailing shape must agree
        if t.dim() != len(tshape) or \
                tuple(t.shape[1:]) != tuple(tshape[1:]):
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(t.shape)}, "
                f"template expects {tuple(tshape)} (trailing dims must "
                "match)")
    if getattr(template, "dtype", None) is not None:
        want = _dtype_name(template)
        got = str(t.dtype).removeprefix("torch.")
        if want != got:
            raise ValueError(f"checkpoint leaf {key!r} has dtype {got}, "
                             f"template expects {want}")
    return t


def save_checkpoint(directory: str, step: int, state, *,
                    meta: dict | None = None) -> str:
    """Atomically write ``state`` (a dict of leaves, nested or flat) at
    ``step``. Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    payload, dtypes = {}, {}
    for key, leaf in _flatten(state).items():
        payload[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "state.npz"), **payload)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "_leaf_dtypes": dtypes, **(meta or {})}, f)
    with open(os.path.join(tmp, "meta.json")) as f:
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def load_checkpoint(directory: str, template, step: int | None = None):
    """Load the newest (or the given step's) checkpoint into
    ``template``'s structure (a dict of leaves with ``shape`` and
    ``dtype``, nested or flat). Returns (state, meta); raises
    ``ValueError`` naming the leaf when a leaf's trailing shape or dtype
    differs from the template's."""
    steps = list_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    names = meta.pop("_leaf_dtypes", {})
    with np.load(os.path.join(path, "state.npz")) as z:
        flat = {k: _to_tensor(z[k], names.get(k, z[k].dtype.name))
                for k in z.files}
    return _unflatten_into(template, flat), meta


def list_steps(directory: str) -> list[int]:
    """The steps of the checkpoints under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name.split("_", 1)[1])
                  for name in os.listdir(directory)
                  if name.startswith("step_"))


def elastic_reshard(worker_stacked, new_num_workers: int):
    """Re-seed a ``[W, ...]`` worker-replica stack onto W' workers: the
    replicas assigned cyclically, a truncation for W' <= W, and for W' > W
    new workers start from existing replicas (any DFL worker's model is
    a model)."""
    def reshard(leaf):
        idx = torch.arange(new_num_workers) % leaf.shape[0]
        return leaf[idx.to(leaf.device)] if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf)[idx.numpy()]
    if isinstance(worker_stacked, dict):
        return {k: elastic_reshard(v, new_num_workers)
                for k, v in worker_stacked.items()}
    return reshard(worker_stacked)


class CheckpointManager:
    """Retention and convenience around ``save_checkpoint`` /
    ``load_checkpoint``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def save(self, step: int, state, meta: dict | None = None) -> str:
        """Save at ``step`` and drop all but the newest ``keep``."""
        path = save_checkpoint(self.directory, step, state, meta=meta)
        for old in list_steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{old:08d}"),
                          ignore_errors=True)
        return path

    def restore(self, template, step: int | None = None):
        """``load_checkpoint`` of this manager's directory."""
        return load_checkpoint(self.directory, template, step)

    def latest_step(self) -> int | None:
        """The newest step saved, or None."""
        steps = list_steps(self.directory)
        return steps[-1] if steps else None
