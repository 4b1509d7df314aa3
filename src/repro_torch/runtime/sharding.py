"""Worker layouts and sharding rules — the port of
``repro.runtime.sharding``: the DFL worker count of a named-axis mesh
(``worker_axes_in_mesh``, ``num_workers``), the worker-stacked shapes
and the ``[W, b / W, ...]`` batch split of launch/train's round step,
the worker-stack layout of the sharded DFL engines, which keep each
worker's whole replica on its worker's shard (only the leading worker
dim splits, contiguously, ``rows = w_pad / n_shards`` rows a shard), and
the reference's spec rules, which map every parameter, batch and
decode-cache leaf of a production mesh to a partition spec.

A spec is the counterpart of a ``PartitionSpec``: a tuple with one entry
a dim, each ``None`` (replicated), an axis name, or a tuple of axis
names (the dim split over their product). The rules are pure functions
of leaf names, shapes and a mesh's ``.shape`` dict ({axis: size}), so
any object with one serves: a ``DeviceMesh`` of ``meta`` slots stands
for the 256-chip pod (``launch/dryrun.py`` reads its bytes per device
from them).

The model axis (``model_extent``): a worker's replica over the m slots
of the mesh axis beside the worker axes. The round step executes the
rules there for every family (``registry.MODEL_AXIS_FAMILIES``, by
``within_worker``): under ``"tp"`` (the dense, moe, hybrid and xlstm
families) a slot holds the piece of each leaf that ``param_spec`` gives
it (``leaf_splits``, ``cut_leaf``, ``join_leaf``: one dim split into m
equal contiguous pieces, or the leaf whole where the rule replicates it
or ``_dims_divisible`` keeps it whole); under ``"dp"`` (the dense,
encdec and vlm families) every slot holds the whole replica and takes
its share of the worker's batch (``batch_slots``, ``train_batch_spec``'s
split over ``model``). FSDP axes, dp's fallback to a sequence split and
a tp cut inside a head raise ``NotImplementedError`` (``MODEL_AXIS``:
ROADMAP.md queue 1, item 4.4).
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from repro_torch.models.registry import MODEL_AXIS_FAMILIES


# ---------------------------------------------------------------------------
# Param rules
# ---------------------------------------------------------------------------

# name pattern -> (trailing rank, spec builder(tp, fsdp)); the spec applies
# to the trailing `rank` dims, leading (stacked layer) dims replicate
_COL = lambda tp, fsdp: (fsdp, tp)           # noqa: E731  [in, out] column-parallel
_ROW = lambda tp, fsdp: (tp, fsdp)           # noqa: E731  [in, out] row-parallel

_RULES: list[tuple[re.Pattern, int, object]] = [
    # embeddings / heads
    (re.compile(r"embed$"), 2, lambda tp, f: (tp, None)),
    (re.compile(r"lm_head$"), 2, _COL),
    # MoE expert banks: experts over the TP axis (EP); within-expert FSDP
    (re.compile(r"moe/w_(gate|up)$"), 3, lambda tp, f: (tp, f, None)),
    (re.compile(r"moe/w_down$"), 3, lambda tp, f: (tp, None, f)),
    (re.compile(r"moe/router$"), 2, lambda tp, f: (f, None)),
    (re.compile(r"moe/shared/w_(gate|up)$"), 2, _COL),
    (re.compile(r"moe/shared/w_down$"), 2, _ROW),
    # attention
    (re.compile(r"attn/w[qkv]$"), 2, _COL),
    (re.compile(r"attn/wo$"), 2, _ROW),
    # dense MLP
    (re.compile(r"mlp/w_(up|gate)$"), 2, _COL),
    (re.compile(r"mlp/w_down$"), 2, _ROW),
    # mamba2
    (re.compile(r"mamba/in_proj$"), 2, _COL),
    (re.compile(r"mamba/out_proj$"), 2, _ROW),
    (re.compile(r"mamba/conv_w$"), 2, lambda tp, f: (None, tp)),
    # xlstm mLSTM
    (re.compile(r"w_up$"), 2, _COL),
    (re.compile(r"w(q|k|v)$"), 2, _COL),
    (re.compile(r"w_down$"), 2, _ROW),
    (re.compile(r"w_(i|f)gate$"), 2, lambda tp, f: (f, None)),
    # xlstm sLSTM
    (re.compile(r"w_in$"), 2, _COL),
    (re.compile(r"(^|/)r$"), 3, lambda tp, f: (tp, None, None)),
    (re.compile(r"w_ffn_(gate|up)$"), 2, _COL),
    (re.compile(r"w_ffn_down$"), 2, _ROW),
]


def _spec(entries) -> tuple:
    """A spec from its entries, normalised as a ``PartitionSpec`` is: a
    tuple of one axis becomes the axis, an empty one ``None``."""
    return tuple(None if e == () else e[0] if isinstance(e, tuple) and
                 len(e) == 1 else e for e in entries)


def _axes_size(mesh, ax) -> int:
    """The slots a spec entry (an axis name or a tuple of them) spans."""
    return math.prod(mesh.shape[a] for a in
                     (ax if isinstance(ax, tuple) else (ax,)))


def _dims_divisible(shape, spec, mesh) -> tuple:
    """Drop shardings that don't divide the dim (e.g. 15 heads on 16-way)."""
    return tuple(None if ax is None or dim % _axes_size(mesh, ax) else ax
                 for dim, ax in zip(shape, spec))


def _present(axes, mesh):
    """First axis of ``axes`` present in the mesh (or None)."""
    for a in axes:
        if a in mesh.shape:
            return a
    return None


def param_spec(name: str, leaf_shape, cfg, mesh, *,
               worker_dim: bool) -> tuple:
    """The spec of parameter leaf ``name`` (the reference's path,
    ``blocks/attn/wq``) of ``leaf_shape``, with or without the leading
    worker dim.

    within_worker == "dp": params replicate inside the worker (tp=None);
    the worker's batch splits over the idle model axis instead. GQA with
    kv_heads < TP width: wk / wv stay replicated (the standard fix for
    kv < tp)."""
    tp = _present(cfg.tp_axes, mesh) if cfg.within_worker == "tp" else None
    fsdp = _present(cfg.fsdp_axes, mesh)
    shape = tuple(leaf_shape[1:] if worker_dim else leaf_shape)
    trailing = ()
    for pat, rank, builder in _RULES:
        if pat.search(name) and len(shape) >= rank:
            trailing = builder(tp, fsdp)
            break
    if tp is not None and re.search(r"attn/w[kv]$", name) \
            and cfg.num_kv_heads % mesh.shape[tp] != 0:
        trailing = (fsdp, None)                  # replicate kv heads
    spec = (None,) * (len(shape) - len(trailing)) + tuple(trailing)
    spec = _dims_divisible(shape, spec, mesh)
    if worker_dim:
        spec = (worker_axes_in_mesh(cfg, mesh) or None,) + spec
    return _spec(spec)


def param_pspecs(cfg, mesh, shapes: dict, *, worker_dim: bool = True
                 ) -> dict[str, tuple]:
    """{name: spec} of ``shapes`` ({name: shape}, as
    ``registry.leaf_shapes`` gives them, with the worker dim when
    ``worker_dim``)."""
    return {k: param_spec(k, s, cfg, mesh, worker_dim=worker_dim)
            for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# Batch / cache rules
# ---------------------------------------------------------------------------

def train_batch_spec(cfg, mesh, name: str, leaf_shape) -> tuple:
    """Train batches are worker-stacked: [W, b_w, ...]. The within-worker
    batch dim splits over whatever axes the params leave idle: "data" for
    FSDP archs (worker = pod), "model" for within-worker-DP archs."""
    w = worker_axes_in_mesh(cfg, mesh)
    avail = [a for a in ("data", "model") if a in mesh.shape
             and a not in w]
    if cfg.within_worker != "dp":
        avail = [a for a in avail if a != "model"]
    chosen: list[str] = []
    size = 1
    for a in avail:                       # greedy product divisibility
        if len(leaf_shape) > 1 and leaf_shape[1] % (size * mesh.shape[a]) == 0:
            chosen.append(a)
            size *= mesh.shape[a]
    spec = [w or None, tuple(chosen) if chosen else None] \
        + [None] * (len(leaf_shape) - 2)
    # batch too small to use "model"? fall back to sequence parallelism
    seq_dim = 3 if name == "mrope_positions" else 2   # [W,b,3,S] vs [W,b,S,..]
    if cfg.within_worker == "dp" and "model" not in chosen \
            and len(leaf_shape) > seq_dim \
            and leaf_shape[seq_dim] % mesh.shape["model"] == 0:
        spec[seq_dim] = "model"
    return _spec(spec)


def serve_batch_spec(cfg, mesh, leaf_shape) -> tuple:
    """Serving batches: [B, ...] batch over (pod, data) when divisible.

    ``cfg.serve_seq_shard``: within-worker-DP archs replicate params over
    "model"; sharding dim 1 (sequence) over "model" dedups the forward
    every model slot would compute, at the cost of per-layer K/V
    all-gathers."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    first = axes if axes and leaf_shape[0] % _axes_size(mesh, axes) == 0 \
        else None
    spec = [first] + [None] * (len(leaf_shape) - 1)
    if cfg.serve_seq_shard and cfg.within_worker == "dp" \
            and "model" in mesh.shape and len(leaf_shape) > 1 \
            and leaf_shape[1] % mesh.shape["model"] == 0:
        spec[1] = "model"
    return _spec(spec)


_KV_CACHE = re.compile(r"(^|/)(k|v|xk|xv|attn_k|attn_v|local_k|local_v|"
                       r"global_k|global_v|tail_k|tail_v)$")


def cache_spec(cfg, mesh, name: str, leaf_shape, batch: int) -> tuple:
    """Decode-cache leaves: KV caches [..., B, S, hkv, hd], SSM states.

    batch > 1: batch over (pod, data), sequence over model (psum'd
    contraction). batch == 1 (long-context): sequence over (data, model).
    """
    tp = _present(cfg.tp_axes, mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dims = list(leaf_shape)
    spec: list = [None] * len(dims)
    # the batch dim: the first dim equal to `batch` (after stack dims)
    b_idx = dims.index(batch) if batch in dims else None
    dp_size = _axes_size(mesh, dp_axes)
    if _KV_CACHE.search(name):
        s_idx = b_idx + 1 if b_idx is not None else len(dims) - 3
        if batch > 1:
            if b_idx is not None and batch % dp_size == 0 and dp_axes:
                spec[b_idx] = dp_axes
            if tp and dims[s_idx] % mesh.shape[tp] == 0:
                spec[s_idx] = tp
        else:
            axes = tuple(a for a in (*dp_axes, tp) if a)
            if axes and dims[s_idx] % _axes_size(mesh, axes) == 0:
                spec[s_idx] = axes
    else:
        # SSM / mLSTM / conv states: shard heads or channels over model
        if tp:
            for i in range(len(dims) - 1, -1, -1):
                if dims[i] % mesh.shape[tp] == 0 and dims[i] >= mesh.shape[tp]:
                    spec[i] = tp
                    break
        if batch > 1 and b_idx is not None and batch % dp_size == 0 \
                and dp_axes:
            spec[b_idx] = dp_axes
    return _spec(spec)


def cache_specs(cfg, mesh, cache_shapes: dict, batch: int
                ) -> dict[str, tuple]:
    """{name: spec} of a serving cache ({name: shape}; the reference's
    ``cache_shardings``): ``cache_spec`` a leaf, () for a 0-d leaf."""
    return {k: cache_spec(cfg, mesh, k, s, batch) if len(s) else ()
            for k, s in cache_shapes.items()}


def spec_shards(mesh, spec) -> int:
    """The slots a leaf of ``spec`` is split over: the product of the
    sizes of the axes that shard it (its bytes a device are its bytes
    over this)."""
    return math.prod(_axes_size(mesh, ax) for ax in spec if ax is not None)


def worker_axes_in_mesh(cfg, mesh) -> tuple[str, ...]:
    """The subset of ``cfg.worker_axes`` present in the mesh."""
    return tuple(a for a in cfg.worker_axes if a in mesh.shape)


def num_workers(cfg, mesh) -> int:
    """DFL worker count = product of the mesh's worker-axis sizes."""
    n = 1
    for a in worker_axes_in_mesh(cfg, mesh):
        n *= mesh.shape[a]
    return max(n, 1)


MODEL_AXIS = ("is not ported to repro_torch yet (ROADMAP.md queue 1, item "
              "4.4: the model axis runs every family without FSDP axes, "
              "dp's sequence fallback or a tp cut inside a head)")


def mesh_workers(mesh, worker_axes) -> int:
    """``num_workers`` over ``worker_axes``: the product of their sizes."""
    return math.prod(size for a, size in mesh.shape.items()
                     if a in worker_axes)


def model_extent(cfg, mesh) -> int:
    """m, the slots a worker's replica spans: the size of the mesh's
    model axis (``cfg.tp_axes``'s first present axis), 1 where every
    axis beside the worker axes has size 1. Raises
    ``NotImplementedError`` (``MODEL_AXIS``) for what the port does not
    execute: a model axis under a family and ``within_worker`` that
    ``MODEL_AXIS_FAMILIES`` does not pair (the published configs' pairs
    all run), an FSDP axis of size > 1, or any other axis of size > 1
    beside the workers."""
    workers = worker_axes_in_mesh(cfg, mesh)
    rest = {a: s for a, s in mesh.shape.items()
            if a not in workers and s > 1}
    if not rest:
        return 1
    if cfg.family not in MODEL_AXIS_FAMILIES.get(cfg.within_worker, ()):
        raise NotImplementedError(
            f"the model axis {rest} on the {cfg.family} family under "
            f"within_worker={cfg.within_worker!r} " + MODEL_AXIS)
    fsdp = [a for a in cfg.fsdp_axes if a in rest]
    if fsdp:
        raise NotImplementedError(f"FSDP over {fsdp} " + MODEL_AXIS)
    tp = _present(cfg.tp_axes, mesh)
    if set(rest) != {tp}:
        raise NotImplementedError(f"mesh axes {rest} beside the worker "
                                  f"axes {workers} " + MODEL_AXIS)
    return rest[tp]


def batch_slots(cfg, mesh, name: str, leaf_shape) -> int:
    """The pieces the model axis cuts a worker's batch leaf ``[W, b_w,
    ...]`` into along b_w (``train_batch_spec``): m under
    ``within_worker="dp"`` (slot j takes rows [j b_w / m, (j + 1) b_w /
    m)), 1 under tp (every slot reads the whole batch). Raises
    ``NotImplementedError`` where dp falls back to a sequence split (b_w
    does not divide by m)."""
    m = model_extent(cfg, mesh)
    if m == 1:
        return 1
    tp = _present(cfg.tp_axes, mesh)
    spec = train_batch_spec(cfg, mesh, name, leaf_shape)
    if len(spec) > 1 and spec[1] == tp:
        return m
    if any(e == tp or (isinstance(e, tuple) and tp in e) for e in spec):
        raise NotImplementedError(
            f"batch leaf {name!r} of {tuple(leaf_shape)}: {leaf_shape[1]} "
            f"sequences a worker do not split over {m} slots and dp falls "
            "back to a sequence split, which " + MODEL_AXIS)
    return 1


def leaf_split(name: str, leaf_shape, cfg, mesh) -> int | None:
    """The dim of one worker's leaf ``leaf_shape`` (no worker dim) that
    ``param_spec`` splits over the model axis, or None where every slot
    holds the leaf whole."""
    spec = param_spec(name, leaf_shape, cfg, mesh, worker_dim=False)
    dims = [i for i, ax in enumerate(spec) if ax is not None]
    if len(dims) > 1:
        raise NotImplementedError(f"leaf {name!r} split over {spec} "
                                  + MODEL_AXIS)
    return dims[0] if dims else None


# the leaves whose split dim holds ``cfg.num_heads`` heads: the attention's
# queries, the mLSTM's q / k / v columns and w_down rows, the sLSTM's
# recurrence (split on its heads dim, so whole heads or kept whole)
_HEAD_LEAVES = re.compile(r"(attn/wq|(mlstm|tail)/(wq|wk|wv|w_down)|"
                          r"(^|/)r)$")


def leaf_splits(cfg, mesh, shapes: dict) -> dict[str, int | None]:
    """{name: ``leaf_split``} over one worker's ``shapes``. Raises
    ``NotImplementedError`` where a split of ``_HEAD_LEAVES`` is not on
    head boundaries (a slot would hold part of a head: xlstm-1.3b's 4
    heads from m = 8 up)."""
    m = model_extent(cfg, mesh)
    out = {k: leaf_split(k, s, cfg, mesh) if m > 1 else None
           for k, s in shapes.items()}
    for k, dim in out.items():
        if dim is not None and _HEAD_LEAVES.search(k) and \
                cfg.num_heads % m:
            raise NotImplementedError(
                f"{cfg.num_heads} heads over {m} slots split a head of "
                f"{k!r}; that " + MODEL_AXIS)
    return out


def piece_shape(shape, dim: int | None, m: int) -> tuple[int, ...]:
    """A slot's piece of a leaf of ``shape`` split along ``dim`` over m
    slots (the whole shape where ``dim`` is None)."""
    shape = tuple(shape)
    if dim is None:
        return shape
    return shape[:dim] + (shape[dim] // m,) + shape[dim + 1:]


def cut_leaf(t: torch.Tensor, dim: int | None, m: int,
             lead: int = 0) -> list[torch.Tensor]:
    """The m slots' pieces of ``t`` (views): equal contiguous blocks of its
    dim ``lead + dim`` (``lead`` leading dims, such as the worker dim,
    come before the leaf's own), or ``t`` itself for every slot where
    ``dim`` is None."""
    if dim is None:
        return [t] * m
    return list(torch.chunk(t, m, dim=lead + dim))


def join_leaf(pieces, dim: int | None, lead: int = 0) -> torch.Tensor:
    """Inverse of ``cut_leaf``: the whole leaf from its m pieces (the first
    slot's copy where ``dim`` is None)."""
    if dim is None:
        return pieces[0]
    return torch.cat(list(pieces), dim=lead + dim)


def _stacked(spec, w: int):
    """One shape (a tuple of ints) or (shape, dtype) pair with a leading
    dim of ``w``."""
    if len(spec) == 2 and isinstance(spec[1], torch.dtype):
        return ((w, *spec[0]), spec[1])
    return (w, *spec)


def stack_worker_dim(shapes: dict, w: int) -> dict:
    """Add a leading worker dim to every leaf of ``shapes`` ({name:
    shape} as ``registry.leaf_shapes`` gives it, or {name: (shape,
    dtype)} as ``registry.batch_shapes``)."""
    return {k: _stacked(v, w) for k, v in shapes.items()}


def split_batch_shapes(shapes: dict, w: int) -> dict:
    """{name: (shape, dtype)} of a global batch [b, ...] -> the per-worker
    split [W, b / W, ...] (the reference's ``_split_batch_for_workers``;
    b must divide by W)."""
    out = {}
    for k, (shape, dt) in shapes.items():
        b = shape[0]
        if b % w and w != 1:
            raise ValueError(f"batch leaf {k!r} of {b} rows does not split "
                             f"over {w} workers")
        out[k] = ((w, b // w, *shape[1:]), dt)
    return out


def split_batch(batch: dict, w: int) -> dict:
    """A global batch {name: [b, ...]} -> {name: [W, b / W, ...]} views,
    worker i taking rows [i·b/W, (i+1)·b/W)."""
    split_batch_shapes({k: (tuple(v.shape), v.dtype)
                        for k, v in batch.items()}, w)
    return {k: v.reshape(w, v.shape[0] // w, *v.shape[1:])
            for k, v in batch.items()}


def worker_stack_spec(ndim: int, axes) -> tuple:
    """Spec for one worker-stacked leaf: leading dim over ``axes``, rest
    replicated. The flat DFL engines keep every within-worker dim dense
    (the whole replica lives on its worker's shard), so this is the only
    spec shape the sharded path needs."""
    return _spec((tuple(axes),) + (None,) * (ndim - 1))


def worker_shard_extent(mesh, worker_axes) -> int:
    """Number of row-shards the worker dim is split into: the mesh's
    shards. ``worker_axes`` must name the mesh's one axis."""
    if tuple(worker_axes) != (mesh.axis,):
        raise ValueError(f"worker axes {tuple(worker_axes)} are not the "
                         f"mesh's axis ({mesh.axis!r},)")
    return len(mesh.devices)


def pad_rows(a, pad: int, axis: int = 0, fill=0) -> np.ndarray:
    """Pad host array ``a``'s worker ``axis`` with ``pad`` inert rows."""
    a = np.asarray(a)
    if pad == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths, constant_values=fill)
