"""The dry run (``repro_torch.launch.dryrun``) and the kernels' ``meta``
path (``repro_torch.kernels.ops``), on the CPU.

- Traced on ``meta``, each family's smoke config (flash off, remat
  "block") counts exactly the FLOPs that ``dryrun.FlopCount`` counts when
  the same call runs on CPU tensors of the same shapes: a train step's
  local steps (``steps.loss_and_grad``, W = 2; no kernel reached), a
  prefill step and a decode step (``FlopCount`` counts by
  ``FlopCounterMode``'s formulas without its decompositions, which round
  a bf16 step's intermediates: a control shows it). A control traces the
  meta side with remat off and must part.
- Each kernel's ``meta`` tally (``ops.WORK``) equals a count by hand, at
  two shapes: ``gossip_mix``'s bf16-rounded matching call (phase 7's
  trainer row, W = 4, K = 12; and its compressed form) and
  ``consensus_dist`` (worker 0 against its 3 partners), the codecs, and
  flash causal, windowed and full. A control counts a causal flash call
  over all its keys and must part. A CPU call adds nothing; operands on
  the CPU and on ``meta`` together get ``_check_cuda``'s error.
- ``run_cell``'s record has the reference's keys (read from the
  reference's source, whose import would set ``XLA_FLAGS``), and its
  ``bytes_per_device`` equals the sum computed from the reference's own
  specs and ``jax.eval_shape`` leaf shapes (the port's train rows in
  f32, the serving leaves in their dtypes) on the 16 x 16 mesh, for a
  train, a prefill and a decode cell of smollm-360m cut to 2 layers.
- A train cell the step executes on the 16 x 16 mesh's model axis
  (smollm-360m in dp; internlm2-20b, olmoe-1b-7b and zamba2-7b in tp;
  depth 1) is traced with it, its bytes a device from the executed
  layout equal to the reference's specs' sum. A (2, 2) round of the moe,
  hybrid, xlstm, encdec and vlm smoke configs counts the same FLOPs on
  ``meta`` as on the CPU.
- The CLI prints the reference's last line and writes its records.
"""
from __future__ import annotations

import ast
import contextlib
import json
import math
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as ref_get_config
from repro.models import registry as ref_registry
from repro.runtime import sharding as ref_sharding
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import registry
from repro_torch.runtime import sharding, steps

# xdist runs one test file a worker (--dist loadfile): keep each on one core
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
META = torch.device("meta")
FAMILIES = {"dense": "smollm-360m", "moe": "olmoe-1b-7b",
            "hybrid": "zamba2-7b", "xlstm": "xlstm-1.3b",
            "encdec": "whisper-large-v3", "vlm": "qwen2-vl-2b"}
W = 2
TRAIN = InputShape("train_4k", seq_len=32, global_batch=2 * W, kind="train")
PREFILL = InputShape("prefill_32k", seq_len=64, global_batch=2,
                     kind="prefill")
DECODE = InputShape("decode_32k", seq_len=64, global_batch=2, kind="decode")


def _cfg(arch: str, **kw):
    return replace(get_smoke_config(arch), use_flash_kernel=False, **kw)


def _one_worker(cfg) -> dict:
    return registry.init_params(cfg, torch.Generator().manual_seed(0))


def _local_steps(cfg, device) -> int:
    layout = steps.train_layout(cfg, TRAIN)
    split = sharding.split_batch_shapes(registry.batch_shapes(cfg, TRAIN), W)
    if device == META:
        flat = torch.empty(W, layout.param_count, device=META)
        batch = {k: torch.empty(s, dtype=dt, device=META)
                 for k, (s, dt) in split.items()}
    else:
        flat = layout.flatten({k: v[None].expand(W, *v.shape)
                               for k, v in _one_worker(cfg).items()})
        batch = registry.make_batch(cfg, TRAIN, torch.Generator()
                                    .manual_seed(1), TRAIN.global_batch // W,
                                    num_workers=W)
        assert {k: tuple(v.shape) for k, v in batch.items()} == \
            {k: s for k, (s, _) in split.items()}
    return dryrun.count(lambda f, b: steps.loss_and_grad(cfg, layout, f, b),
                        flat, batch).flops


def _serving_step(cfg, shape, device) -> int:
    mesh = make_debug_mesh((1, 1), devices=["cpu"])
    bundle = steps.make_step(cfg, mesh, shape)
    if device == META:
        return dryrun.count(bundle.fn,
                            *dryrun.step_args(bundle, shape)).flops
    params = {k: v[None] for k, v in _one_worker(cfg).items()}
    if shape.kind == "prefill":
        batch = registry.make_batch(cfg, shape, torch.Generator()
                                    .manual_seed(1))
        args = (params, {k: v for k, v in batch.items() if k != "labels"})
        assert {k: v.shape for k, v in args[1].items()} == \
            {k: v.shape for k, v in bundle.abstract_args[1].items()}
    else:
        cache = registry.make_decode_cache(cfg, shape.global_batch,
                                           shape.seq_len, device="cpu")
        cache["len"].fill_(shape.seq_len - 1)
        args = (params, cache, torch.zeros(1, shape.global_batch, 1,
                                           dtype=torch.int32))
    return dryrun.count(bundle.fn, *args).flops


@pytest.mark.parametrize("family", list(FAMILIES))
def test_local_steps_meta_counts_as_cpu(family):
    cfg = _cfg(FAMILIES[family])
    assert cfg.remat == "block"
    meta = _local_steps(cfg, META)
    assert meta > 0 and meta == _local_steps(cfg, "cpu")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_serving_step_meta_counts_as_cpu(family, kind):
    cfg = _cfg(FAMILIES[family])
    shape = PREFILL if kind == "prefill" else DECODE
    meta = _serving_step(cfg, shape, META)
    assert meta > 0 and meta == _serving_step(cfg, shape, "cpu")


def _meta_local_steps(cfg):
    layout = steps.train_layout(cfg, TRAIN)
    split = sharding.split_batch_shapes(registry.batch_shapes(cfg, TRAIN), W)
    flat = torch.empty(W, layout.param_count, device=META)
    batch = {k: torch.empty(s, dtype=dt, device=META)
             for k, (s, dt) in split.items()}
    return (lambda f, b: steps.loss_and_grad(cfg, layout, f, b)), flat, batch


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_token_loop_extrapolation_is_the_full_trace(kind):
    """xlstm-1.3b's sLSTM loops traced for 2 and 3 trips and extrapolated
    (``dryrun.count_unrolled``) count exactly the full trace's FLOPs and
    bytes, and the peak within 1%."""
    cfg = _cfg("xlstm-1.3b")
    if kind == "train":
        fn, *args = _meta_local_steps(cfg)
    else:
        bundle = steps.make_step(cfg, make_debug_mesh((1, 1),
                                                      devices=["cpu"]),
                                 PREFILL)
        fn, args = bundle.fn, bundle.abstract_args
    full = dryrun.count(fn, *args)
    fast = dryrun.count_unrolled(fn, *args)
    assert (fast.flops, fast.bytes, fast.args) == \
        (full.flops, full.bytes, full.args)
    assert abs(fast.peak - full.peak) <= 0.01 * full.peak
    once = dryrun.count_unrolled(fn, *args, unroll=False)
    assert once.flops < full.flops


def test_token_loop_refuses_real_tensors():
    cfg = _cfg("xlstm-1.3b")
    with dryrun.xlstm.token_loop(2), pytest.raises(ValueError,
                                                   match="meta trace"):
        _local_steps(cfg, "cpu")


def test_flop_count_leaves_the_arithmetic_as_it_is():
    """``dryrun.FlopCount`` counts what ``FlopCounterMode`` counts, and a
    bf16 backward through silu run under it is bit-equal to the uncounted
    one; the control, ``FlopCounterMode``, decomposes ``silu_backward``
    and parts (measured: 17,574 of 65,536 gradient entries)."""
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(256, 256, generator=gen).to(torch.bfloat16)
    w = torch.randn(256, 256, generator=gen).to(torch.bfloat16)

    def grad(mode=None):
        x = x0.clone().requires_grad_()
        with mode or contextlib.nullcontext():
            torch.nn.functional.silu(x @ w).float().square().sum().backward()
        return x.grad

    plain, counter, control = grad(), dryrun.FlopCount(), FlopCounterMode(
        display=False)
    assert torch.equal(grad(counter), plain)
    assert not torch.equal(grad(control), plain)
    # x @ w and x's gradient product, 2 n^3 FLOPs each
    assert counter.flops == control.get_total_flops() == 2 * 2 * 256 ** 3


def test_control_remat_off_on_one_side_parts():
    meta = _local_steps(_cfg("smollm-360m", remat="none"), META)
    assert meta != _local_steps(_cfg("smollm-360m"), "cpu")


# ---------------------------------------------------------------------------
# the kernels' meta path
# ---------------------------------------------------------------------------

def _work(fn) -> tuple[int, int]:
    before = dict(ops.WORK)
    fn()
    return (ops.WORK["flops"] - before["flops"],
            ops.WORK["bytes"] - before["bytes"])


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


@pytest.mark.parametrize("length", [4_000, 361_821_120])
def test_gossip_mix_tally_by_hand(length):
    x, w = _meta(4, length), _meta(4, 12)
    y = None

    def call():
        nonlocal y
        y = ops.gossip_mix(x, x, w, round_bf16=True)
    # x read, y written, w read; 5 operations a term
    assert _work(call) == (5 * 4 * 12 * length, (8 * length + 48) * 4)
    assert y.shape == x.shape and y.device == META
    payload = _meta(4, length)
    # the compressed form: x and the payload (u and centre) read
    assert _work(lambda: ops.gossip_mix(x, payload, w, centre=payload,
                                        round_bf16=True)) == \
        (5 * 4 * 12 * length, (12 * length + 48) * 4)


@pytest.mark.parametrize("length", [4_000, 361_821_120])
def test_consensus_dist_tally_by_hand(length):
    assert _work(lambda: ops.consensus_dist(_meta(length), _meta(3, length))
                 ) == (3 * 3 * length, (4 * length + 3) * 4)


@pytest.mark.parametrize("p", [6922, 78_643_200])
def test_codec_tallies_by_hand(p):
    x = _meta(4, p)
    q, scales = ops.quantize_block(x)
    row_len, _, n_tiles = ops.ref.wire_tiles(p)
    assert (q.dtype, tuple(q.shape)) == (torch.int8, (4, row_len))
    assert tuple(scales.shape) == (4, n_tiles)
    assert _work(lambda: ops.quantize_block(x)) == \
        (6 * 4 * p, 16 * p + 4 * row_len + 16 * n_tiles)
    assert _work(lambda: ops.dequantize_block(q, scales, p)) == \
        (4 * p, 20 * p + 16 * n_tiles)


def _windowed_pairs(s: int, window: int) -> int:
    """Causal with a window, S = Sk: query i reaches min(i + 1, window)."""
    return window * (window + 1) // 2 + (s - window) * window


# (case, B, S, Sk, Hq, Hkv, hd, causal, window, pairs by hand)
FLASH_CASES = (
    ("causal", 2, 4096, 4096, 15, 5, 64, True, 0, 4096 * 4097 // 2),
    ("causal-small", 1, 300, 300, 4, 2, 128, True, 0, 300 * 301 // 2),
    ("windowed", 2, 2048, 2048, 32, 16, 128, True, 1024,
     _windowed_pairs(2048, 1024)),
    ("windowed-small", 1, 512, 512, 4, 4, 112, True, 64,
     _windowed_pairs(512, 64)),
    ("full", 1, 256, 256, 4, 2, 64, False, 0, 256 * 256),
    ("full-shorter-q", 2, 128, 384, 8, 8, 192, False, 0, 128 * 384))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: c[0])
def test_flash_tally_by_hand(case, dtype):
    _, b, s, sk, hq, hkv, hd, causal, window, pairs = case
    q, k, v = (_meta(b, n, h, hd, dtype=dtype)
               for n, h in ((s, hq), (sk, hkv), (sk, hkv)))
    out = []
    work = _work(lambda: out.append(ops.flash_attention(
        q, k, v, causal=causal, window=window)))
    assert out[0].shape == q.shape and out[0].dtype == dtype
    size = 4 if dtype == torch.float32 else 2
    assert work == (4 * b * hq * hd * pairs,
                    (2 * b * s * hq + 2 * b * sk * hkv) * hd * size)


def test_control_flash_over_all_keys_parts(monkeypatch):
    monkeypatch.setattr(ops, "flash_pairs",
                        lambda s, sk, causal, window: s * sk)
    with pytest.raises(AssertionError):
        test_flash_tally_by_hand(FLASH_CASES[0], torch.bfloat16)


def test_cpu_calls_tally_nothing():
    x = torch.randn(4, 64)
    w = torch.full((4, 4), 0.25)
    assert _work(lambda: ops.gossip_mix(x, x, w, round_bf16=True)) == (0, 0)
    assert _work(lambda: ops.consensus_dist(x[0], x[1:])) == (0, 0)
    q = torch.randn(1, 16, 2, 64)
    assert _work(lambda: ops.flash_attention(q, q, q)) == (0, 0)


def test_cpu_and_meta_together_raise():
    cpu, meta = torch.zeros(4, 64), _meta(4, 64)
    msg = "all operands must be on one CUDA device"
    with pytest.raises(ValueError, match=msg):
        ops.gossip_mix(cpu, meta, torch.zeros(4, 4))
    with pytest.raises(ValueError, match=msg):
        ops.consensus_dist(cpu[0], meta[1:])
    q, scales = ops.quantize_block(meta)
    with pytest.raises(ValueError, match=msg):
        ops.dequantize_block(q, torch.zeros(tuple(scales.shape)), 64)
    qc = torch.zeros(1, 16, 2, 64)
    with pytest.raises(ValueError, match=msg):
        ops.flash_attention(qc, _meta(1, 16, 2, 64), _meta(1, 16, 2, 64))


def test_meta_keeps_the_operand_checks():
    with pytest.raises(TypeError, match="x must be torch.float32"):
        ops.gossip_mix(_meta(4, 64, dtype=torch.bfloat16),
                       _meta(4, 64, dtype=torch.bfloat16), _meta(4, 4))
    with pytest.raises(ValueError, match="must be contiguous"):
        ops.consensus_dist(_meta(64), _meta(64, 3).t())


# ---------------------------------------------------------------------------
# run_cell's record and the CLI
# ---------------------------------------------------------------------------

def _reference_record_keys() -> set[str]:
    """The keys of the record the reference's ``run_cell`` builds (its
    ``rec = {...}``), read from its source."""
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", "") == "rec" for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("no rec = {...} in the reference's dryrun.py")


CUT = {"num_layers": 2}
# (shape, tau_max): a cell of each kind on the 16 x 16 mesh (W = 16)
RECORD_CELLS = {"train": InputShape("train_4k", seq_len=64, global_batch=16,
                                    kind="train"),
                "prefill": InputShape("prefill_32k", seq_len=64,
                                      global_batch=32, kind="prefill"),
                "decode": InputShape("decode_32k", seq_len=64,
                                     global_batch=32, kind="decode")}


def _ref_leaves(tree) -> list:
    out = []
    jax.tree_util.tree_map_with_path(lambda p, l: out.append((p, l)), tree)
    return out


def _shards(mesh, spec) -> int:
    return math.prod(math.prod(mesh.shape[a] for a in
                               (e if isinstance(e, tuple) else (e,)))
                     for e in spec if e is not None)


def _ref_bytes_per_device(shape: InputShape, arch: str = "smollm-360m",
                          cut=CUT) -> float:
    """The cell's argument bytes a device from the reference's specs and
    ``jax.eval_shape`` leaves: train rows in f32 (the port's flat [W, P]
    matrix), every other leaf in its own dtype."""
    cfg = replace(ref_get_config(arch), **cut)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    params = jax.eval_shape(
        lambda: ref_registry.init_params(cfg, jax.random.PRNGKey(0)))
    w = ref_sharding.num_workers(cfg, mesh)
    tot = 0.0
    for path, leaf in _ref_leaves(params):
        if shape.kind == "train":
            full = (w, *leaf.shape)
            spec = ref_sharding.param_spec(path, full, cfg, mesh,
                                           worker_dim=True)
            tot += 4 * math.prod(full) / _shards(mesh, spec)
        else:
            spec = ref_sharding.param_spec(path, leaf.shape, cfg, mesh,
                                           worker_dim=False)
            tot += leaf.size * leaf.dtype.itemsize / _shards(mesh, spec)
    if shape.kind == "train":
        for name, sds in ref_registry.batch_shapes(cfg, shape).items():
            split = (w, sds.shape[0] // w, *sds.shape[1:])
            spec = ref_sharding.train_batch_spec(cfg, mesh, name, split)
            tot += math.prod(split) * sds.dtype.itemsize / _shards(mesh, spec)
        return tot + 4 * w + 4                       # taus, lr
    if shape.kind == "prefill":
        for name, sds in ref_registry.batch_shapes(cfg, shape).items():
            if name != "labels":
                spec = ref_sharding.serve_batch_spec(cfg, mesh, sds.shape)
                tot += sds.size * sds.dtype.itemsize / _shards(mesh, spec)
        return tot
    b = shape.global_batch
    cache = jax.eval_shape(
        lambda: ref_registry.make_decode_cache(cfg, b, shape.seq_len))
    for path, leaf in _ref_leaves(cache):
        spec = ref_sharding.cache_spec(cfg, mesh, path, leaf.shape, b) \
            if leaf.ndim else ()
        tot += leaf.size * leaf.dtype.itemsize / _shards(mesh, spec)
    return tot + 4 * b / _shards(mesh, ref_sharding.serve_batch_spec(
        cfg, mesh, (b, 1)))


@pytest.fixture(scope="module")
def records():
    return {kind: dryrun.run_cell(
        "smollm-360m", shape, cfg_overrides=CUT, verbose=False,
        train_kw={"tau_max": 1} if kind == "train" else None)
        for kind, shape in RECORD_CELLS.items()}


@pytest.mark.parametrize("kind", list(RECORD_CELLS))
def test_record_has_the_references_keys(records, kind):
    rec = records[kind]
    assert set(rec) == _reference_record_keys()
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["peak_bytes_per_device"] >= rec["bytes_per_device"] > 0
    if kind == "train":
        assert rec["collectives"] == {"collective-permute": 2}
    else:
        assert rec["collective_bytes"] == 0


@pytest.mark.parametrize("kind", list(RECORD_CELLS))
def test_bytes_per_device_from_the_references_specs(records, kind):
    want = _ref_bytes_per_device(RECORD_CELLS[kind])
    assert np.isclose(records[kind]["bytes_per_device"], want,
                      rtol=1e-12, atol=0)


# train cells the step executes over the 16 x 16 mesh's model axis: 16
# sequences a worker (one a slot under smollm-360m's dp), S = 64, depth 1
MODEL_AXIS_CELL = InputShape("train_4k", seq_len=64, global_batch=256,
                             kind="train")


# each arch's cut: depth 1 (zamba2-7b one Mamba2 block and its shared
# attention + MLP block)
MODEL_AXIS_CUTS = {"smollm-360m": {"num_layers": 1},
                   "internlm2-20b": {"num_layers": 1},
                   "olmoe-1b-7b": {"num_layers": 1},
                   "zamba2-7b": {"num_layers": 1, "ssm_every": 1}}


@pytest.mark.parametrize("arch", list(MODEL_AXIS_CUTS))
def test_model_axis_cell_bytes_from_the_executed_layout(arch):
    """A train cell is traced with its model axis (dp: every slot the
    whole replica and a sequence of its worker's 16; tp: each slot its
    pieces — internlm2-20b's 8 kv heads replicated over 16 slots,
    olmoe-1b-7b's 64 experts 4 a slot, zamba2-7b's Mamba2 projections
    split on 911 of in_proj's columns and 448 of out_proj's rows a slot):
    its bytes a device, read from the executed layout, equal the
    reference's spec rules' sum; under dp the cell of one sequence a
    worker (dp's sequence fallback) is traced without it."""
    cut = MODEL_AXIS_CUTS[arch]
    cfg = replace(get_config(arch), **cut)
    prod = make_production_mesh(devices=[META] * 256)
    assert dryrun.executes_model_axis(cfg, prod, MODEL_AXIS_CELL)
    # one sequence a worker: dp would split it over the sequence (refused,
    # so traced on the workers alone); tp reads the batch whole
    assert dryrun.executes_model_axis(cfg, prod, RECORD_CELLS["train"]) \
        == (cfg.within_worker == "tp")
    rec = dryrun.run_cell(arch, MODEL_AXIS_CELL, cfg_overrides=cut,
                          verbose=False, train_kw={"tau_max": 1})
    assert rec["ok"] and rec["hlo_flops"] > 0
    assert np.isclose(rec["bytes_per_device"],
                      _ref_bytes_per_device(MODEL_AXIS_CELL, arch, cut),
                      rtol=1e-12, atol=0)


def _tallied(name: str):
    """``ops.<name>`` that also tallies ``ops.WORK`` on a CPU call, as a
    launch on the card does (by a call on ``meta`` copies of the
    operands), before it runs the plain version."""
    orig = getattr(ops, name)

    def meta(v):
        return torch.empty_like(v, device=META) \
            if isinstance(v, torch.Tensor) else v

    def call(*args, **kw):
        orig(*map(meta, args), **{k: meta(v) for k, v in kw.items()})
        return orig(*args, **kw)

    return call


@pytest.mark.parametrize("family", ["moe", "hybrid", "xlstm", "encdec",
                                    "vlm"])
def test_model_axis_round_meta_counts_as_cpu(family, monkeypatch):
    """A round of the (2, 2) step (W = 2 workers over 2 model slots, tau
    1, measured distances; xlstm in tp, encdec and vlm in dp, a sequence
    a slot) on each family's smoke config counts the same
    FLOPs traced on ``meta`` (the dry run's count, ``dryrun.count`` of
    the step on its abstract arguments) and run on CPU tensors, the
    kernels tallied on the CPU as a launch tallies them."""
    cfg = _cfg(FAMILIES[family])
    mesh = make_debug_mesh((W, 2), devices=["cpu"] * (2 * W))
    bundle = steps.make_train_step(cfg, mesh, TRAIN,
                                   measure_distances=True)
    assert bundle.layout.model == 2
    meta = dryrun.count(bundle.fn, *bundle.abstract_args).flops
    for name in ("gossip_mix", "consensus_dist"):
        monkeypatch.setattr(ops, name, _tallied(name))
    slots = bundle.layout.flatten_slots(
        {k: v[None].expand(W, *v.shape) for k, v in _one_worker(cfg).items()})
    batch = registry.make_batch(cfg, TRAIN, torch.Generator().manual_seed(1),
                                TRAIN.global_batch // W, num_workers=W)
    cpu = dryrun.count(bundle.fn, tuple(slots), batch,
                       torch.ones(W, dtype=torch.int32), 0.01).flops
    assert meta > 0 and meta == cpu


def test_cli(tmp_path, capsys):
    out = tmp_path / "cells.jsonl"
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                        "--json", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[H100 16x16] smollm-360m x decode_32k: OK")
    assert lines[-1] == "1/1 cells compiled OK"
    (rec,) = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert set(rec) == _reference_record_keys()
