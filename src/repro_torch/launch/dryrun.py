"""Dry run of an (architecture x input shape) cell on the ``meta`` device
— the port of ``repro.launch.dryrun``.

For a cell it builds the step (``steps.make_step``: the train step for
train shapes, prefill or decode for the serving shapes) on ``meta``
arguments (shape and dtype, no storage), calls it once, and counts what
the call does:

- FLOPs: ``FlopCount`` over the call (the products of PyTorch's own
  operations, by ``torch.utils.flop_counter``'s formulas), plus the
  hand-written kernels' own FLOPs, which their ``meta`` calls tally
  (``kernels/ops.WORK``);
- bytes: every aten operation that is not a view adds the bytes of its
  tensor inputs and outputs (``TrafficCounter``; an allocation moves
  nothing) — what an unfused eager step moves, which is the port's real
  traffic — plus the kernels' bytes. Traced in the config's own dtype
  (the reference's f32 trace scaled to bf16 has no counterpart);
- collective bytes: what the round's matching gossip moves between
  workers (``roofline.collective_bytes_from_tables``);
- bytes a device: the step's arguments under the sharding rules
  (``runtime/sharding``) on the production mesh, and a peak estimate
  from the live bytes of the trace (``TrafficCounter``).

Then it prints the reference's lines and the roofline terms at the H100
constants (``launch/roofline.py``). It needs no card and launches
nothing. A train cell the port's step executes on the model axis (every
family without FSDP, b_w a multiple of the axis under dp, tp cuts on
head boundaries: ``sharding.model_extent``, ``sharding.leaf_splits``,
``sharding.batch_slots``) is traced on the
production mesh's worker and model axes of ``meta`` slots, its bytes a
device read from the executed layout (a slot's [W, P_slot] pieces and
batch share), which must equal the spec rules' sum; any other cell with
the production mesh's workers (``sharding.num_workers``: 16 on 16 x 16
for smollm-360m) on a mesh whose other axes have size 1. The counts are
global quantities over the mesh's chips, as the reference stores them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k [--multi-pod] [--all] [--json out.json]

Tracing costs Python dispatch a PyTorch operation, whatever the sizes:
xlstm-1.3b's sLSTM loops over every token, so its loops are traced for
2 and 3 trips and counted by extrapolation, which is exact
(``count_unrolled``, ``models/xlstm.token_loop``). ``--no-unroll``
traces one trip and counts it once: a fast pass whose counts are not for
the roofline.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import sys
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import topology as topo
from repro_torch.kernels import ops
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import registry, xlstm
from repro_torch.runtime import sharding
from repro_torch.runtime import steps as steps_mod

META = torch.device("meta")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class TrafficCounter(TorchDispatchMode):
    """Bytes and live memory of the aten operations run under it.

    ``bytes``: every operation that is not a view adds the bytes of its
    tensor inputs and outputs (each operand read once, each result
    written once: an in-place update counts its tensor twice); an
    allocation (``empty*``) adds nothing. ``peak``: the most bytes of
    storage alive at once — ``live`` starts at the bytes the caller
    already holds (the step's arguments), each fresh result (a return
    that aliases no input) adds its storage's bytes and gives them back
    when the storage is freed (``weakref.finalize``).

    Under a capped sLSTM token loop (``loop``, an ``xlstm.TokenLoop`` of 3
    trips) the trips left out stand in the peak as copies of the middle
    trip: what the middle trip allocated and still holds when it ends
    (the states the hidden-state list and the backward keep) counts once
    more for each token left, until it is freed."""

    MIDDLE = 1

    def __init__(self, live: int = 0, loop=None):
        super().__init__()
        self.bytes = 0
        self.live = self.peak = live
        self.loop = loop
        self.kept = 0           # the middle trips' bytes held past them
        self._trip: dict[int, int] = {}      # this middle trip's, alive
        self._kept: set[int] = set()
        self._keys = itertools.count()
        self._in_middle = False

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        if self._trip.pop(key, None) is None and key in self._kept:
            self._kept.discard(key)
            self.kept -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.loop is not None:
            middle = self.loop.trip == self.MIDDLE
            if self._in_middle and not middle:         # the trip ended
                self.kept += sum(self._trip.values())
                self._kept.update(self._trip)
                self._trip = {}
            self._in_middle = middle
        if func.is_view:
            return out
        results = _tensors(out)
        if not func.__name__.startswith(("empty", "new_empty")):
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs))))
            self.bytes += sum(map(_nbytes, results))
        if all(r.alias_info is None for r in func._schema.returns):
            seen = set()
            for t in results:
                st = t.untyped_storage()
                if id(st) in seen:
                    continue
                seen.add(id(st))
                key, n = next(self._keys), st.nbytes()
                self.live += n
                if self._in_middle:
                    self._trip[key] = n
                weakref.finalize(st, self._free, key, n)
            left = max(self.loop.lengths) - self.loop.trips \
                if self.loop is not None and self.loop.lengths else 0
            self.peak = max(self.peak, self.live + left * self.kept)
        return out


class FlopCount(TorchDispatchMode):
    """FLOPs of the aten operations run under it, by
    ``torch.utils.flop_counter``'s formulas (``flop_registry``: the
    matrix products, convolutions and attention), each operation run as
    it is. ``FlopCounterMode`` counts the same operations but decomposes
    those it has no formula for (``func.decompose``: ``silu_backward``
    into its elementwise steps), which on bf16 operands rounds each
    step's result: a round counted by it is not the round run uncounted
    to the last bit."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out


@dataclasses.dataclass
class Counts:
    """One counted call: FLOPs and bytes (PyTorch's operations and the
    kernels' own), the peak live bytes, and the bytes the arguments
    held."""

    flops: int
    bytes: int
    peak: int
    args: int


def count(fn, *args, loop=None) -> Counts:
    """Call ``fn(*args)`` once under ``FlopCount`` and
    ``TrafficCounter`` (``loop``: its capped token loop), with the
    kernels' tally (``ops.WORK``) read around it."""
    arg_bytes = sum(map(_nbytes, _tensors(args)))
    work = dict(ops.WORK)
    flop_mode = FlopCount()
    traffic = TrafficCounter(arg_bytes, loop)
    with flop_mode, traffic:
        out = fn(*args)
        del out
    return Counts(
        flops=flop_mode.flops + ops.WORK["flops"] - work["flops"],
        bytes=traffic.bytes + ops.WORK["bytes"] - work["bytes"],
        peak=traffic.peak, args=arg_bytes)


def count_unrolled(fn, *args, unroll: bool = True) -> Counts:
    """``count(fn, *args)`` with each sLSTM token loop
    (``xlstm.token_loop``) traced for 2 and for 3 trips and the counts
    extrapolated to the loop's length: exact for the FLOPs and bytes, as
    every trip issues the same operations at the same shapes and nothing
    else changes with the trips (the hidden states past them repeat the
    last, whose gradient adds then come one a token left). The peak is
    the 3-trip trace's, each trip left out standing in it as a copy of
    the middle one (``TrafficCounter``): an estimate. A step with no such
    loop is traced once. ``unroll=False``: one trip, counted once (a fast
    pass, not for the roofline)."""
    with xlstm.token_loop(2 if unroll else 1) as loop:
        two = count(fn, *args)
    if not unroll or not loop.lengths:
        return two
    if len(loop.lengths) != 1 or min(loop.lengths) < 3:
        raise ValueError(f"token loops of lengths {sorted(loop.lengths)}: "
                         "one length of at least 3 extrapolates")
    (s,) = loop.lengths
    with xlstm.token_loop(3) as loop:
        three = count(fn, *args, loop=loop)
    return Counts(flops=two.flops + (s - 2) * (three.flops - two.flops),
                  bytes=two.bytes + (s - 2) * (three.bytes - two.bytes),
                  peak=three.peak, args=three.args)


def executes_model_axis(cfg, mesh, shape: InputShape) -> bool:
    """Whether the port's round step runs ``shape``'s train cell over
    ``mesh``'s model axis (a serving step runs one replica whole)."""
    if shape.kind != "train":
        return False
    try:
        if sharding.model_extent(cfg, mesh) == 1:
            return False
        sharding.leaf_splits(cfg, mesh, registry.leaf_shapes(cfg))
        w = sharding.num_workers(cfg, mesh)
        for k, (s, _) in sharding.split_batch_shapes(
                registry.batch_shapes(cfg, shape), w).items():
            sharding.batch_slots(cfg, mesh, k, s)
    except NotImplementedError:
        return False
    return True


def _trace_mesh(cfg, prod, shape: InputShape):
    """``prod``'s worker axes at their sizes, and its model axis where the
    port executes it on this cell (``executes_model_axis``), every other
    axis of size 1, over ``meta`` slots: the mesh the port's step runs."""
    keep = set(sharding.worker_axes_in_mesh(cfg, prod))
    if executes_model_axis(cfg, prod, shape):
        keep.add(next(a for a in cfg.tp_axes if a in prod.shape))
    sizes = [s if a in keep else 1 for a, s in prod.shape.items()]
    return make_mesh(sizes, tuple(prod.shape),
                     devices=[META] * math.prod(sizes))


def _per_slot(leaves: dict, specs: dict, mesh) -> float:
    """Bytes one slot of ``mesh`` holds: each leaf's bytes over the slots
    its spec splits it over."""
    return sum(_nbytes(t) / sharding.spec_shards(mesh, specs[k])
               for k, t in leaves.items())


def _train_rows(params) -> int:
    """W of a train step's parameter argument ([W, P], or a model axis's
    tuple of [W, P_slot])."""
    return (params[0] if isinstance(params, tuple) else params).shape[0]


def argument_bytes_per_slot(cfg, mesh, shape: InputShape, bundle) -> float:
    """The step's arguments, a slot's share under the sharding rules:
    a train step's [W, P] f32 rows leaf by leaf (``param_spec`` with the
    worker dim), its batch leaves (``train_batch_spec``, the tau dim
    unsplit) and the replicated taus and lr; a serving step's [1, ...]
    leaves (``param_spec`` without it), its batch (``serve_batch_spec``)
    and decode cache (``cache_spec``)."""
    args = bundle.abstract_args
    if shape.kind == "train":
        params, batch, taus, lr = args
        w = _train_rows(params)
        leaves = {k: torch.empty((w, *s), device=META)
                  for k, s in bundle.layout.whole_shapes().items()}
        tot = _per_slot(leaves, sharding.param_pspecs(
            cfg, mesh, {k: t.shape for k, t in leaves.items()}), mesh)
        split = sharding.split_batch_shapes(
            registry.batch_shapes(cfg, shape), w)
        for k, t in batch.items():
            s = split[k][0]
            spec = sharding.train_batch_spec(cfg, mesh, k, s)
            if t.dim() > len(s):          # [W, tau, b_w, ...]: tau unsplit
                spec = spec[:1] + (None,) + spec[1:]
            tot += _nbytes(t) / sharding.spec_shards(mesh, spec)
        return tot + _nbytes(taus) + _nbytes(lr)
    params = {k: v[0] for k, v in args[0].items()}
    tot = _per_slot(params, sharding.param_pspecs(
        cfg, mesh, {k: t.shape for k, t in params.items()},
        worker_dim=False), mesh)
    if shape.kind == "prefill":
        return tot + sum(_nbytes(t) / sharding.spec_shards(
            mesh, sharding.serve_batch_spec(cfg, mesh, t.shape[1:]))
            for t in args[1].values())
    cache = {k: v[0] if v.dim() else v for k, v in args[1].items()}
    tot += _per_slot(cache, sharding.cache_specs(
        cfg, mesh, {k: t.shape for k, t in cache.items()},
        shape.global_batch), mesh)
    return tot + _nbytes(args[2]) / sharding.spec_shards(
        mesh, sharding.serve_batch_spec(cfg, mesh, args[2].shape[1:]))


def executed_bytes_per_slot(cfg, mesh, shape: InputShape, bundle) -> float:
    """A train step's arguments as the port lays them out on a model
    axis, a slot's share: its matrix of pieces ([W, P_slot] f32, W over
    the worker axes' slots), its share of the batch (``batch_slots``
    along b_w, the tau dim unsplit) over the worker axes' slots, and the
    taus and lr every slot reads."""
    params, batch, taus, lr = bundle.abstract_args
    w = _train_rows(params)
    wslots = math.prod(s for a, s in mesh.shape.items()
                       if a in sharding.worker_axes_in_mesh(cfg, mesh))
    tot = w * bundle.layout.param_count * 4 / wslots
    split = sharding.split_batch_shapes(registry.batch_shapes(cfg, shape), w)
    for k, t in batch.items():
        tot += _nbytes(t) / wslots / sharding.batch_slots(
            cfg, mesh, k, split[k][0])
    return tot + _nbytes(taus) + _nbytes(lr)


def step_args(bundle, shape: InputShape) -> tuple:
    """The arguments a cell's step is traced on: ``bundle.abstract_args``
    (``meta``), but for a decode step's cache length, which the step
    reads on the host (``int(cache["len"])``): a host scalar, the token
    decoded the last the cache takes (``seq_len - 1``; the decode's
    attention spans the whole capacity whatever the length)."""
    args = bundle.abstract_args
    if shape.kind != "decode":
        return args
    return (args[0], {**args[1], "len": torch.tensor(
        shape.seq_len - 1, dtype=torch.int32)}, args[2])


def run_cell(arch: str, shape_name, *, multi_pod: bool = False,
             train_kw: dict | None = None, verbose: bool = True,
             unroll: bool = True, cfg_overrides: dict | None = None,
             mesh=None) -> dict:
    """Count one cell (module doc) -> the reference's record.

    ``shape_name``: a name of ``SHAPES`` or an ``InputShape``.
    ``mesh``: the mesh the step runs on (default: the production mesh,
    traced over its workers, each slot a chip); a given mesh's slots
    count as the distinct devices they lie on (4 slots of one card are
    one chip), and a chip holds its slots' shares. ``unroll=False``:
    one trip of each sLSTM token loop, counted once (not for the
    roofline). ``lower_s`` is the seconds to build the step, ``compile_s``
    those of the counted call."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = shape_name if isinstance(shape_name, InputShape) \
        else SHAPES[shape_name]
    if mesh is None:
        size = 512 if multi_pod else 256
        spec_mesh = make_production_mesh(multi_pod=multi_pod,
                                         devices=[META] * size)
        trace_mesh, chips = _trace_mesh(cfg, spec_mesh, shape), size
        mesh_name = "2x16x16" if multi_pod else "16x16"
    else:
        spec_mesh = trace_mesh = mesh
        chips = len(set(mesh.devices))
        mesh_name = "x".join(map(str, mesh.shape.values()))
    slots_a_chip = math.prod(spec_mesh.shape.values()) / chips
    train_kw = dict(train_kw or {})

    t0 = time.time()
    bundle = steps_mod.make_step(cfg, trace_mesh, shape, **train_kw)
    args = step_args(bundle, shape)
    t_lower = time.time() - t0
    counts = count_unrolled(bundle.fn, *args, unroll=unroll)
    t_count = time.time() - t0 - t_lower

    coll = rl.CollectiveStats()
    if shape.kind == "train":
        w = _train_rows(args[0])
        adj = train_kw.get("adj")
        adj = steps_mod._default_adj(w) if adj is None else adj
        mixfn = (topo.mixing_matrix_metropolis
                 if train_kw.get("mixing") == "metropolis"
                 else topo.mixing_matrix_uniform)
        # every model-axis slot sends its pieces (a whole leaf once a slot)
        coll = rl.collective_bytes_from_tables(
            adj, mixfn(adj) if w > 1 else np.ones((1, 1)),
            4 * bundle.layout.param_count * bundle.layout.model)
    roof = rl.roofline_from_counts(counts.flops, counts.bytes,
                                   coll.total_bytes, chips, coll)
    mf = rl.model_flops(cfg, shape)
    per_slot = argument_bytes_per_slot(cfg, spec_mesh, shape, bundle)
    if shape.kind == "train" and bundle.layout.model > 1:
        executed = executed_bytes_per_slot(cfg, trace_mesh, shape, bundle)
        if not math.isclose(executed, per_slot, rel_tol=1e-12):
            raise AssertionError(f"{arch} x {shape.name}: the executed "
                                 f"layout holds {executed} bytes a slot, "
                                 f"the spec rules {per_slot}")
        per_slot = executed
    per_device = per_slot * slots_a_chip
    temp = (counts.peak - counts.args) / chips
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "chips": chips, "ok": True,
        "lower_s": round(t_lower, 1), "compile_s": round(t_count, 1),
        "hlo_flops": roof.flops, "hlo_bytes": roof.hbm_bytes,
        "collective_bytes": roof.collective_bytes,
        "collectives": dict(coll.count_by_kind),
        "collective_bytes_by_kind": dict(coll.bytes_by_kind),
        "compute_s": roof.compute_s, "memory_s": roof.memory_s,
        "collective_s": roof.collective_s, "dominant": roof.dominant,
        "model_flops": mf, "useful_fraction": roof.useful_fraction(mf),
        "mfu_bound": roof.mfu(mf),
        "bytes_per_device": per_device,
        "temp_bytes_per_device": temp,
        "peak_bytes_per_device": per_device + temp,
    }
    if verbose:
        print(f"[H100 {mesh_name}] {arch} x {shape.name}: OK "
              f"(build {t_lower:.0f}s trace {t_count:.0f}s)")
        print(f"  memory: args={per_device / 1e9:.2f} GB/dev, "
              f"temp={temp / 1e9:.2f} GB/dev")
        print(f"  counts: {roof.flops:.3e} FLOPs, {roof.hbm_bytes:.3e} HBM "
              f"bytes, {roof.collective_bytes:.3e} collective bytes "
              f"{rec['collectives']}")
        print(f"  roofline: compute={roof.compute_s * 1e3:.2f}ms "
              f"memory={roof.memory_s * 1e3:.2f}ms "
              f"collective={roof.collective_s * 1e3:.2f}ms "
              f"-> {roof.dominant}-bound; "
              f"useful={rec['useful_fraction']:.2f} "
              f"MFU_bound={rec['mfu_bound']:.3f}")
    return rec


def cells(multi_pod: bool):
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name in SHAPES:
            if name in cfg.skip_shapes:
                continue
            yield arch, name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", default=None, help="append records here")
    ap.add_argument("--tau-max", type=int, default=1)
    ap.add_argument("--no-unroll", action="store_true",
                    help="one trip of each sLSTM token loop, counted once: "
                         "a fast pass (not for the roofline)")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated shape filter for --all")
    ap.add_argument("--arches", default=None,
                    help="comma-separated arch filter for --all")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    shape_f = args.shapes.split(",") if args.shapes else None
    arch_f = args.arches.split(",") if args.arches else None
    todo = []
    for mp in meshes:
        if args.all:
            todo += [(a, s, mp) for a, s in cells(mp)
                     if (not shape_f or s in shape_f)
                     and (not arch_f or a in arch_f)]
        else:
            if not (args.arch and args.shape):
                ap.error("--arch/--shape or --all")
            todo.append((args.arch, args.shape, mp))

    records, failures = [], 0
    for arch, shape, mp in todo:
        try:
            rec = run_cell(arch, shape, multi_pod=mp,
                           train_kw={"tau_max": args.tau_max}
                           if SHAPES[shape].kind == "train" else None,
                           unroll=not args.no_unroll)
        except Exception as e:  # noqa: BLE001 — report, keep going
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16", "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
            failures += 1
        records.append(rec)
        if args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print(f"\n{len(records) - failures}/{len(records)} cells compiled OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
