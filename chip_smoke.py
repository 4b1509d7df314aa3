"""GPU smoke run of the PyTorch port (``src/repro_torch``): the quickest
proof that the port builds, launches its kernels and runs its main path
on an NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is non-zero):

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   ``nvcc`` compiles ``src/repro_torch/kernels/csrc`` for sm_90a, one
   process per source started together;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes and a few others — bit-equality required of the
   gossip and codec kernels — with
   CUDA-event times of the kernel, the plain version and the nearest
   PyTorch library call computing the same function: ``gossip_mix``
   (the MLP path's round, a fleet of 100 whose K spans two staged
   chunks, AD-PSGD's pair and the registry path's 8 x 45,228,480
   round), the wire codecs' ``quantize_block``, ``dequantize_block`` and
   ``sparsify_block`` (a top-k gate per row, and rand-k's shared row),
   the edge-list ``gossip_edges`` (W = 30 full graph and ring, the
   W = 2,048 ring and a W = 2,048 ``ba:2`` graph, honest and over a
   lying wire), the Byzantine-robust ``robust_gossip`` (trimmed and
   median, W = 30 full graph, a W = 30 ``erdos:0.3`` graph of mixed
   degrees in a table 32 wide and the W = 2,048 ring in the register
   instances, full graphs of 66, 130 and 300 workers and a W = 1,000
   ``ba:2`` graph of mostly small degrees in the wide one, a full graph
   of 1,100 at P = 256 in the shared one; each line names its instance
   and bound), ``flash_attention``
   (the registry path's local step and measurement stack, smollm-360m's
   train shape, a gemma3-27b local layer, a 192-wide head, the forced
   causal rule, the short-sequence kernel's dispatch limit and one key
   past it, a non-causal Sk = 128 and a short sliding window; each line
   names the instance that ran; within 2e-5, with the f32-FMA bound
   (operations at 67 TFLOP/s or bytes), the tensor-core bound (3 x the
   operations at 495 TFLOP/s, or bytes) and
   ``scaled_dot_product_attention``'s time) and
   ``consensus_dist`` (the kernel benchmark's shape and the registry
   path's width; within 1e-6 relative); and ``launch_floor_us``, the
   time of ``dequantize_block`` on one element, timed the same way;
3. the main path: ``run_algorithm(algo, cfg, fused=True)`` at the
   paper's fleet (30 workers) and MLP (P = 6,922) — FedHP and the
   synchronous baselines uncompressed, FedHP and D-PSGD under int8,
   top-k and rand-k, AD-PSGD uncompressed and under int8; sparse
   edge-list gossip (FedHP, D-PSGD, under int8 and top-k, and the
   reference's W = 2,048 ring); 20% sign-flip attackers with the
   attacked baseline dense and sparse, trimmed:6 dense and sparse, the
   median under a norm-blown attack and AD-PSGD screening; FedHP on
   70 workers over a complete base with trimmed:2 (degree 69: the
   robust kernel's wide instance, its launches asserted); and the
   registry path: a dense LM at smollm-360m's widths (d 960, 15 / 5
   heads of 64, d_ff 2,560; 4 layers, a vocabulary of 6,144) with
   ``use_flash_kernel=True``, FedHP and D-PSGD at W = 8 through
   ``run_dfl_fused(adapter=...)`` — each after a short warm-up run, with
   the launch counters zeroed before each timed run and read after it,
   and held to what the path must launch;
4. the reference engine against the fused engine on the card — FedHP
   uncompressed, under int8 and under top-k, AD-PSGD uncompressed and
   under int8, sparse FedHP uncompressed and under int8, trimmed:6
   sparse and dense, the median, AD-PSGD screening, and the registry
   path's FedHP over an ``erdos:0.5`` base, and the 70-worker trimmed
   FedHP over ``erdos:0.95`` (degrees 65-69): host record fields (and
   screening's rejection counts)
   equal, device metrics within the tests' tolerances (int8's wider,
   ``tests/test_torch_codec_engine.py``).

Then a JSON line describing every kernel, the card line, and the last
line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, without a CUDA device or outside a checkout of the repo.

    python3 chip_smoke.py --trace

instead traces one round of the registry path's FedHP and D-PSGD with
``torch.profiler`` (after a warm-up round): wall and device-busy seconds,
the kernels that take the most device time, and the port's own kernels.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import smollm_360m  # noqa: E402
from repro_torch.configs.base import FedHPConfig  # noqa: E402
from repro_torch.core import compression  # noqa: E402
from repro_torch.core import engine, fused, modelspec  # noqa: E402
from repro_torch.core import robust  # noqa: E402
from repro_torch.core import topology as topo  # noqa: E402
from repro_torch.core.algorithms import make_strategy  # noqa: E402
from repro_torch.core.experiment import (run_algorithm,  # noqa: E402
                                         setup_experiment)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.simulation.cluster import SimCluster  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside
# the tensor cores — the bound of a kernel is the larger of its bytes
# over the first and its operations over the second
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# and TF32 on the tensor cores: flash's tile kernel does each f32
# product as three TF32 products (3xTF32), so its tensor-core bound is
# the larger of the bytes and 3 flops at this rate
TF32_FLOPS = 495e12
# the paper's MLP (32 -> 64 -> 64 -> 10): the width of a worker's row
PAPER_MLP_P = 6922

# the paper's configuration (benchmarks/run.py of the reference)
PAPER_CFG = FedHPConfig(num_workers=30, tau_init=8, tau_max=30, lr=0.15,
                        lr_decay=0.993, batch_size=32, seed=5)
PAPER_KW = dict(non_iid_p=0.4, spread=3.0)
# 20% sign-flip attackers on the paper's fleet, trimmed by their count
# (the reference's scenario benchmark, benchmarks/run.py:630-639)
BYZ = dict(tau_init=4, byzantine=(0, 5, 10, 15, 20, 25),
           byzantine_attack="signflip")
SPARSE = dict(gossip="sparse")
# the reference's large-W sparse leg (benchmarks/run.py:366-373): a
# W = 2,048 ring the dense [W, W] path cannot reach
BIG_CFG = FedHPConfig(num_workers=2048, rounds=3, tau_init=2, tau_max=4,
                      lr=0.1, batch_size=16, seed=5, base_topology="ring",
                      gossip="sparse")
BIG_KW = dict(non_iid_p=0.1, num_samples=65536)
BIG_ROUNDS = 3
# the fleet past 64 neighbours: 70 workers on a complete base (degree 69,
# the robust kernel's wide instance), two sign-flip attackers, trimmed:2
# (the case the port refused before the wide instance, ROADMAP.md); phase
# 4 runs it over erdos:0.95 (every worker still of degree 65-69): on a
# complete base every honest worker trims the same multiset and the
# engines' consensus metrics are f32 noise around zero
WIDE_FIELDS = dict(num_workers=70, byzantine=(0, 1), robust="trimmed:2",
                   base_topology="full")
WIDE_ROUNDS = 10
# the main path's runs: (algorithm, config fields over PAPER_CFG)
MAIN_PATHS = (("fedhp", {}), ("dpsgd", {}), ("ldsgd", {}), ("pens", {}),
              ("fedhp", dict(compress="int8")),
              ("fedhp", dict(compress="topk:0.1")),
              ("fedhp", dict(compress="randk:0.1")),
              ("dpsgd", dict(compress="int8")),
              ("dpsgd", dict(compress="topk:0.1")),
              ("dpsgd", dict(compress="randk:0.1")),
              ("adpsgd", {}), ("adpsgd", dict(compress="int8")),
              ("fedhp", SPARSE),
              ("dpsgd", dict(SPARSE, base_topology="ring")),
              ("fedhp", dict(SPARSE, compress="int8")),
              ("dpsgd", dict(SPARSE, compress="topk:0.1")),
              ("dpsgd", BYZ), ("dpsgd", dict(BYZ, **SPARSE)),
              ("dpsgd", dict(BYZ, robust="trimmed:6")),
              ("dpsgd", dict(BYZ, **SPARSE, robust="trimmed:6")),
              ("fedhp", dict(BYZ, robust="trimmed:6")),
              ("dpsgd", dict(BYZ, **SPARSE, robust="median",
                             byzantine_attack="largenorm")),
              ("adpsgd", dict(BYZ, robust="screen:8")))
PARITY_PATHS = (("fedhp", {}), ("fedhp", dict(compress="int8")),
                ("fedhp", dict(compress="topk:0.1")), ("adpsgd", {}),
                ("adpsgd", dict(compress="int8")),
                ("fedhp", SPARSE), ("fedhp", dict(SPARSE, compress="int8")),
                ("dpsgd", dict(BYZ, **SPARSE, robust="trimmed:6")),
                # FedHP over a base that is not complete (degrees up to
                # 29: the D_PAD = 32 instance): on a complete graph every
                # honest worker trims the same multiset, their rows come
                # out identical, and the consensus metric of both engines
                # is f32 noise around zero (PERF.md, section 6)
                ("fedhp", dict(BYZ, robust="trimmed:6",
                               base_topology="erdos:0.9")),
                ("dpsgd", dict(BYZ, robust="median")),
                ("adpsgd", dict(BYZ, robust="screen:8")),
                ("fedhp", dict(WIDE_FIELDS, base_topology="erdos:0.95")))
MAIN_ROUNDS = 20
WARMUP_ROUNDS = 2
PARITY_ROUNDS = 10

# the registry path: smollm-360m's published widths, its depth cut from 32
# to 4 layers and its vocabulary from 49,152 to 6,144 (make_token_data
# draws a dense V x V transition matrix per document class), trained in
# f32 with the flash-attention kernel in every forward pass
LM_MODEL = replace(smollm_360m.CONFIG, num_layers=4, vocab_size=6144,
                   dtype="float32", remat="none", use_flash_kernel=True)
LM_PARAMS = 45_228_480
# the spec that builds the same token corpus (the spec cannot tie the
# embeddings or turn the kernel on, so the run's adapter is built from
# LM_MODEL); S = 16 is the spec's default sequence length
LM_SPEC = "dense:d=960,layers=4,heads=15,kv=5,ff=2560,vocab=6144,seq=16"
LM_SEQ = 16
LM_CLASSES = 8
# the reference's quick-mode fleet (benchmarks/run.py:763-766)
LM_CFG = FedHPConfig(num_workers=8, tau_init=6, tau_max=12, lr=0.05,
                     seed=5, model=LM_SPEC)
LM_KW = dict(non_iid_p=0.4)
LM_ROUNDS = 3
LM_WARMUP_ROUNDS = 1
# phase 4 over a sparse base (17 of 28 links at W = 8, seed 5): on a
# complete or near-complete mix (erdos:0.9, 27 links) the fleet ends the
# round 0.028 apart at P = 45 M, and the two engines' mixing formulas,
# which differ in the last ulp, move that distance by 2.8e-4 relative —
# past the 1e-4 of the parity contract; over this base the distance is
# 0.25-0.29 and they agree within 2e-6 (PERF.md, section 6, PR 14)
LM_PARITY_FIELDS = dict(base_topology="erdos:0.5")

# the kernels' agreement with their plain versions where it is not
# bit-equality: flash attention reassociates the softmax sums (the
# reference's own flash tolerance, tests/test_kernels.py), consensus_dist
# sums in another order
FLASH_ATOL = FLASH_RTOL = 2e-5
CONSENSUS_RTOL = 1e-6
# kernels no main path launches
OFF_PATH = ("consensus_dist",)

# reference vs fused on the card: the tests' tolerances
# (tests/test_torch_engine.py, tests/test_torch_codec_engine.py) — host
# fields exact; accuracy to one eval sample, loss and consensus to 1e-4
# relative, under int8 loss to 2e-3 and consensus to 1e-2 (a 1-ulp
# difference on a half-quantum boundary moves a coordinate by a quantum)
EXACT = ("round", "round_time", "waiting_time", "mean_tau", "num_links",
         "cumulative_time", "staleness")
ACC_ATOL = 1.0 / 512
REL_TOL = 1e-4
CONSENSUS_ATOL = 1e-6
INT8_LOSS_RTOL = 2e-3
INT8_CONSENSUS_RTOL = 1e-2


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing: CUDA events around a batch of launches queued behind a sleep
# kernel, so the device runs them back to back however slow the host is
# ---------------------------------------------------------------------------

def _sleep_cycles_per_ms() -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    cycles = 20_000_000
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def time_ms(fn, cycles_per_ms: float, *, batch: int,
            reps: int = 50) -> float:
    """Median over ``reps`` batches of the device time per call of
    ``fn`` (each batch: ``batch`` calls between two CUDA events, queued
    behind a sleep kernel long enough to cover their enqueueing; keep
    ``batch`` times the kernels per call well under the launch queue)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batch):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(cycles_per_ms * (4.0 * host_ms + 2.0))
    per_call = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / batch)
    return statistics.median(per_call)


# ---------------------------------------------------------------------------
# phase 2: gossip_mix against its plain version
# ---------------------------------------------------------------------------

def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` of device memory traffic and
    ``flops`` f32 operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def _mix_inputs(gen, b, k, length, main: bool):
    x = torch.randn(b, length, generator=gen, device="cuda")
    if main:
        # the main path: u = x, w = the uniform Eq. 6 mixing matrix of a
        # random connected topology, with departed workers' identity rows
        # (three of a larger fleet, one of the registry path's eight)
        rng = np.random.default_rng(7)
        adj = topo.erdos_topology(b, 0.3, rng)
        dead = rng.choice(b, 1 if b <= 8 else 3, replace=False)
        alive = np.ones(b, bool)
        alive[dead] = False
        adj = topo.repair_connectivity(adj, alive)
        w = torch.tensor(topo.mixing_matrix_uniform(adj), dtype=torch.float32,
                         device="cuda")
        return x, x, w, dead
    u = torch.randn(k, length, generator=gen, device="cuda")
    if k == 1:
        w = torch.full((b, k), 0.5, device="cuda")
    else:
        w = torch.rand(b, k, generator=gen, device="cuda") / k
    return x, u, w, ()


# (case, B, K, L, a fleet's mix with u = x): the MLP path's round (the
# kernel line's shape), an aligned and a short row, AD-PSGD's pair, a
# fleet of 100 (K past one staged chunk of 64 neighbours) and the
# registry path's round (W = 8, P = 45,228,480: u = x is 1.45 GB)
MIX_CASES = (("main", 30, 30, PAPER_MLP_P, True),
             ("aligned", 30, 30, 8192, False),
             ("short", 30, 30, 1000, False),
             ("adpsgd", 1, 1, PAPER_MLP_P, False),
             ("chunked", 100, 100, PAPER_MLP_P, True),
             ("registry", 8, 8, LM_PARAMS, True))


def check_gossip_mix(cycles_per_ms: float) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    main = None
    for name, b, k, length, is_main in MIX_CASES:
        x, u, w, dead = _mix_inputs(gen, b, k, length, is_main)
        y = ops.gossip_mix(x, u, w)
        y_ref = ref.gossip_mix_ref(x, u, w)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        if not torch.equal(y, y_ref):
            raise AssertionError(f"gossip_mix[{name}] differs from its plain "
                                 f"version: max |diff| = {err}")
        for i in dead:
            if not torch.equal(y[i], x[i]):
                raise AssertionError(f"gossip_mix[{name}]: identity row {i} "
                                     "is not an exact no-op")
        worst = max(worst, err)

        def library():
            # the whole function in library calls: the x * (1 - rowsum(w))
            # term, then one addmm
            return torch.addmm(x * (1.0 - w.sum(dim=1))[:, None], w, u)

        lib_err = float((library() - y_ref).abs().max())
        reps = 10 if name == "registry" else 50
        kernel_ms = time_ms(lambda: ops.gossip_mix(x, u, w), cycles_per_ms,
                            batch=10, reps=reps)
        # the plain version is 3 K launches per call
        plain_ms = time_ms(lambda: ref.gossip_mix_ref(x, u, w),
                           cycles_per_ms, batch=2, reps=reps)
        library_ms = time_ms(library, cycles_per_ms, batch=10, reps=reps)
        # each input read once, y written once; on the main path u is x,
        # so its bytes are read once, as x's
        u_bytes = 0 if u.data_ptr() == x.data_ptr() else k * length
        nbytes = (2 * b * length + u_bytes + b * k) * 4
        flops = 3 * b * k * length
        bound_ms, bound_by = _bound(nbytes, flops)
        log("phase2", kernel="gossip_mix", case=name, B=b, K=k, L=length,
            bit_equal=True, max_abs_err=err, addmm_max_abs_diff=lib_err,
            ms=f"{kernel_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
            addmm_ms=f"{library_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
            bound_mb=f"{nbytes / 1e6:.6f}",
            share_of_bound=f"{bound_ms / kernel_ms:.4f}")
        if name == "main":
            main = dict(ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
        # the registry case's 1.45 GB rows are freed before phase 3
        del x, u, w, y, y_ref
        torch.cuda.empty_cache()
    return dict(name="gossip_mix", route="cuda",
                source="src/repro_torch/kernels/csrc/gossip_mix.cu",
                replaces="src/repro/kernels/gossip_mix.py:45",
                max_abs_err=worst, **main)


# ---------------------------------------------------------------------------
# phase 2: the wire codecs' kernels against their plain versions
# ---------------------------------------------------------------------------

def _require_equal(name: str, case: str, pairs) -> float:
    """Bit-equality of each (kernel, plain) output pair; returns the
    largest absolute difference (0.0)."""
    worst = 0.0
    for got, want in pairs:
        worst = max(worst, float((got.double() - want.double()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"{name}[{case}] differs from its plain "
                                 f"version: max |diff| = {worst}")
    return worst


# (case, W, P) of the codec kernels
CODEC_CASES = (("main", 30, 6922), ("adpsgd", 2, 6922),
               ("tiles", 30, 100000), ("short", 30, 1000),
               ("odd", 30, 6921), ("single", 1, 6922))


def check_codecs(cycles_per_ms: float) -> list[dict]:
    """quantize_block, dequantize_block and sparsify_block at the main
    path's [30, 6922] (one tile per worker), AD-PSGD's pair [2, 6922],
    [30, 100000] (13 tiles, the last ragged), [30, 1000], an odd P whose
    rows start on 4 bytes only ([30, 6921]) and one worker ([1, 6922]).
    Each quantize line names its cluster size."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {name: dict(max_abs_err=0.0) for name in
           ("quantize_block", "dequantize_block", "sparsify_block")}

    def record(name, case, err, kernel_fn, plain_fn, library_fn, nbytes,
               flops, **extra):
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        kernel_ms = time_ms(kernel_fn, cycles_per_ms, batch=10)
        plain_ms = time_ms(plain_fn, cycles_per_ms, batch=2)
        library_ms = (time_ms(library_fn, cycles_per_ms, batch=10)
                      if library_fn is not None else None)
        bound_ms, bound_by = _bound(nbytes, flops)
        log("phase2", kernel=name, case=case, bit_equal=True,
            max_abs_err=err, ms=f"{kernel_ms:.6f}",
            plain_ms=f"{plain_ms:.6f}",
            library_ms="none" if library_ms is None else f"{library_ms:.6f}",
            bound_ms=f"{bound_ms:.6f}", bound_mb=f"{nbytes / 1e6:.6f}",
            **extra)
        return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound_ms, bound_by=bound_by)

    for case, w, p in CODEC_CASES:
        x = 0.3 * torch.randn(w, p, generator=gen, device="cuda")
        row_len, tile_len, n_tiles = ref.wire_tiles(p)
        shape = dict(W=w, P=p, tiles=n_tiles)

        q, scales = ops.quantize_block(x)
        err = _require_equal("quantize_block", case,
                             zip((q, scales), ref.quantize_block_ref(x)))
        # x read once, q (the padded wire row) and the scales written
        # once; abs, max, divide, round and clamp per element
        cluster = ops.quantize_cluster(w, n_tiles, tile_len,
                                       ops.sm_count(x.device))
        main = record("quantize_block", case, err,
                      lambda: ops.quantize_block(x),
                      lambda: ref.quantize_block_ref(x), None,
                      4 * w * p + w * row_len + 4 * w * n_tiles,
                      6 * w * p, cluster=cluster, **shape)
        if case == "main":
            out["quantize_block"].update(main)

        y = ops.dequantize_block(q, scales, p)
        err = _require_equal("dequantize_block", case,
                             [(y, ref.dequantize_block_ref(q, scales, p))])
        # one library call computes q * scale where the wire row is whole
        # tiles (the main shape: one 7168-element tile): a broadcast
        # multiply over the padded grid, of which y is the first P columns
        library = None
        if row_len == n_tiles * tile_len:
            q3, s3 = q.view(w, n_tiles, tile_len), scales[:, :, None]

            def library():
                return torch.mul(q3, s3)
        # q's first P bytes of each row and the scales read once, y
        # written once; one multiply per element
        main = record("dequantize_block", case, err,
                      lambda: ops.dequantize_block(q, scales, p),
                      lambda: ref.dequantize_block_ref(q, scales, p),
                      library, w * p + 4 * w * n_tiles + 4 * w * p, w * p,
                      **shape)
        if case == "main":
            out["dequantize_block"].update(main)

        k = max(round(0.1 * p), 1)
        scores = torch.from_numpy(compression.randk_scores(
            compression.sparsify_base_key(5), 3, p)).to("cuda")
        for gate_name, gate in (("topk", x.abs()), ("randk", scores[None])):
            thresh = torch.topk(gate, k, dim=1).values[:, -1] \
                .expand(w).contiguous()
            err = _require_equal(
                "sparsify_block", f"{case}-{gate_name}",
                zip(ops.sparsify_block(x, gate, thresh),
                    ref.sparsify_block_ref(x, gate, thresh)))

            def library(gate=gate, thresh=thresh):
                # the select alone, without the per-tile counts
                return torch.where(gate >= thresh[:, None], x, 0.0)
            # x, the gate (a row per worker, or one shared row) and the
            # thresholds read once, y and the counts written once; a
            # compare and a count per element
            main = record("sparsify_block", f"{case}-{gate_name}", err,
                          lambda gate=gate, thresh=thresh:
                          ops.sparsify_block(x, gate, thresh),
                          lambda gate=gate, thresh=thresh:
                          ref.sparsify_block_ref(x, gate, thresh),
                          library,
                          8 * w * p + 4 * gate.numel() + 4 * w
                          + 4 * w * n_tiles, 2 * w * p, k=k, **shape)
            if case == "main" and gate_name == "topk":
                out["sparsify_block"].update(main)
    src = "src/repro_torch/kernels/csrc/"
    return [dict(name="quantize_block", route="cuda",
                 source=src + "quantize_block.cu",
                 replaces="src/repro/kernels/quantize_block.py:36",
                 **out["quantize_block"]),
            dict(name="dequantize_block", route="cuda",
                 source=src + "quantize_block.cu",
                 replaces="src/repro/kernels/quantize_block.py:70",
                 **out["dequantize_block"]),
            dict(name="sparsify_block", route="cuda",
                 source=src + "sparsify_block.cu",
                 replaces="src/repro/kernels/sparsify_block.py:38",
                 **out["sparsify_block"])]


def launch_floor(cycles_per_ms: float) -> float:
    """The device time (ms) of a launch that does next to nothing:
    ``dequantize_block`` at [1, 1] (one block, one element), timed as
    every kernel is. The share of a small kernel's time no redesign of
    its body can remove."""
    q, scales = ops.quantize_block(torch.ones(1, 1, device="cuda"))
    floor_ms = time_ms(lambda: ops.dequantize_block(q, scales, 1),
                       cycles_per_ms, batch=10)
    log("phase2", launch_floor_us=f"{floor_ms * 1e3:.4f}",
        kernel="dequantize_block", W=1, P=1)
    return floor_ms


# ---------------------------------------------------------------------------
# phase 2: the edge-list and robust gossip kernels
# ---------------------------------------------------------------------------

def _graph(w: int, spec: str, cut=(), pad: int = 0):
    """A ``spec`` graph on ``w`` workers with the workers in ``cut``
    isolated, its CSR edge list on the card (uniform weights; ``pad``
    zero-weight self-loops at vertex 0 appended first, as the reference
    pads) and its adjacency."""
    adj = topo.make_base_topology(w, spec, 5)
    for i in cut:
        adj[i, :] = adj[:, i] = 0
    e = topo.edges_from_adj(adj)
    src, dst, wts = topo.directed_edges(e, topo.edge_mixing_weights(e, w))
    src = np.concatenate([src, np.zeros(pad, np.int32)])
    dst = np.concatenate([dst, np.zeros(pad, np.int32)])
    wts = np.concatenate([wts, np.zeros(pad, np.float32)])
    csr = [torch.from_numpy(a).to("cuda")
           for a in topo.edges_to_csr(src, dst, wts, w)]
    return adj, csr


def _lying(x: torch.Tensor) -> torch.Tensor:
    """The transmitted copy with every fifth row sign-flipped."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return torch.where(rows % 5 == 0, -x, x)


def check_gossip_edges(cycles_per_ms: float) -> dict:
    """gossip_edges at P = 6,922: the W = 30 full graph (870 directed
    edges), a W = 30 ring with padding edges and an isolated worker, the
    W = 2,048 ring (4,096 edges) and a W = 2,048 ``ba:2`` graph (hubs of
    high in-degree), each honest (t = x) and over a lying wire."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    p = PAPER_MLP_P
    cases = [("full30", 30, "full", (), 0), ("ring30-pad", 30, "ring", (3,),
                                             8),
             ("ring2048", 2048, "ring", (), 0),
             ("ba2048", 2048, "ba:2", (), 0)]
    worst, main = 0.0, None
    for case, w, spec, cut, pad in cases:
        _, csr = _graph(w, spec, cut, pad)
        row_ptr, col, wts = csr
        n_edges = int(row_ptr[-1])
        max_in = int((row_ptr[1:] - row_ptr[:-1]).max())
        x = torch.randn(w, p, generator=gen, device="cuda")
        lib_a = torch.sparse_csr_tensor(row_ptr.long(), col[:n_edges].long(),
                                        wts[:n_edges], size=(w, w))
        ones = torch.ones(w, 1, device="cuda")
        for wire, t in (("honest", x), ("lying", _lying(x))):
            name = f"{case}-{wire}"
            y = ops.gossip_edges(x, t, *csr)
            err = _require_equal("gossip_edges", name,
                                 [(y, ref.gossip_edges_ref(x, t, *csr))])
            for i in cut:
                if not torch.equal(y[i], x[i]):
                    raise AssertionError(f"gossip_edges[{name}]: row {i} "
                                         "without edges changed")
            worst = max(worst, err)

            def library(t=t):
                # the whole function in library calls: the CSR
                # off-diagonal weights times t, plus x (1 - rowsum)
                return torch.sparse.mm(lib_a, t) + \
                    x * (1.0 - torch.sparse.mm(lib_a, ones))
            lib_err = float((library() - y).abs().max())
            kernel_ms = time_ms(lambda t=t: ops.gossip_edges(x, t, *csr),
                                cycles_per_ms, batch=10)
            plain_ms = time_ms(lambda t=t: ref.gossip_edges_ref(x, t, *csr),
                               cycles_per_ms, batch=2)
            library_ms = time_ms(library, cycles_per_ms, batch=10)
            # x read once (t too when it is not x), the CSR arrays read
            # once, y written once; a subtract, multiply and add per edge
            # and column
            t_rows = 0 if t is x else w
            nbytes = ((2 * w + t_rows) * p + (w + 1) + 2 * n_edges) * 4
            bound_ms, bound_by = _bound(nbytes, 3 * n_edges * p)
            log("phase2", kernel="gossip_edges", case=name, W=w, P=p,
                E=n_edges, max_in_degree=max_in, bit_equal=True,
                max_abs_err=err, sparse_mm_max_abs_diff=lib_err,
                ms=f"{kernel_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
                sparse_mm_ms=f"{library_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
                bound_by=bound_by, bound_mb=f"{nbytes / 1e6:.6f}")
            if name == "full30-honest":
                main = dict(ms=kernel_ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
    return dict(name="gossip_edges", route="cuda",
                source="src/repro_torch/kernels/csrc/gossip_edges.cu",
                replaces="src/repro/kernels/gossip_edges.py:66",
                max_abs_err=worst, **main)


@functools.lru_cache(maxsize=None)
def _sort_compare_exchanges(cnt: int) -> int:
    """The compare-exchanges that sorting a window of ``cnt`` values needs:
    Batcher's odd-even merge sort for the next power of two, less every
    compare-exchange that touches a slot at or past ``cnt`` (those slots
    would hold +inf, which no compare-exchange moves). The count the
    function needs, whatever network an instance runs (543 at 64 values,
    against a bitonic network's 672)."""
    n = 1 << max(cnt - 1, 0).bit_length()
    count, p = 0, 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p) and \
                            i + j + k < cnt:
                        count += 1
            k //= 2
        p *= 2
    return count


# (case, W, base, cut workers, workers whose degree is set to 0, P, the
# table's width or 0): the main path's W = 30 full graph (D_PAD = 32),
# a W = 30 ``erdos:0.3`` graph (degrees 2 to 10 once workers 1 and 7
# are cut: the sparser bases FedHP's controller builds) in a table
# padded to D_PAD = 32, as the fused engine pads a segment's tables to
# its widest (each block sorts its own worker's window), and the
# W = 2,048 ring (D_PAD = 2), register instances; full graphs of 66,
# 130 and 300 (D = 65, 129 and 299) and a W = 1,000 ``ba:2`` graph (a
# table 102 wide, half its workers of degree 2: each block sorts its own
# worker's window), the wide instance; a full graph of 1,100 (D = 1,099,
# N = 2,048) at P = 256, the shared instance, narrow so that the plain
# version's [W, D + 1, P] window stays near 1.2 GB. Worker 7's degree is
# zeroed so the table keeps its width. A width of 0 is D's, rounded up
# to a power of two for the register instance
ROBUST_CASES = (("full30", 30, "full", (1, 7), (), PAPER_MLP_P, 0),
                ("mixed30", 30, "erdos:0.3", (1, 7), (), PAPER_MLP_P, 32),
                ("ring2048", 2048, "ring", (1, 7), (), PAPER_MLP_P, 0),
                ("full66", 66, "full", (), (7,), PAPER_MLP_P, 0),
                ("full130", 130, "full", (), (7,), PAPER_MLP_P, 0),
                ("full300", 300, "full", (), (7,), PAPER_MLP_P, 0),
                ("ba1000", 1000, "ba:2", (), (7,), PAPER_MLP_P, 0),
                ("full1100", 1100, "full", (), (7,), 256, 0))


# the robust modes phase 2 runs on every table: trimmed by a count and
# by a fraction, and the median
ROBUST_MODES = (("trimmed", 6.0), ("trimmed", 0.2), ("median", 0.0))


def robust_table(w: int, spec: str, cut, zeroed, width: int = 0):
    """A ROBUST_CASES table on the card -> (nbr, deg, the instance a
    launch runs, the compare-exchanges that sorting one column's windows
    needs, each window of its own deg + 1 values: degree-0 rows sort
    nothing). The table is padded to ``width``, or where that is 0 the
    register instance's to D_PAD, as the fused engine pads it."""
    adj, _ = _graph(w, spec, cut=cut)
    nbr_np, deg_np = robust.neighbor_table(adj)
    deg_np[list(zeroed)] = 0
    if not width and ops.robust_instance(nbr_np.shape[1]) == "register":
        width = _pow2(nbr_np.shape[1])
    nbr_np = np.pad(nbr_np, ((0, 0), (0, max(width - nbr_np.shape[1], 0))))
    kind = ops.robust_instance(nbr_np.shape[1])
    exchanges = sum(_sort_compare_exchanges(int(k) + 1)
                    for k in deg_np if k > 0)
    nbr, deg = (torch.from_numpy(a).to("cuda") for a in (nbr_np, deg_np))
    return nbr, deg, kind, exchanges


def robust_bound(w: int, p: int, d: int, exchanges: int) -> tuple:
    """(bound ms, what binds, bytes): x and t read once, the table and
    the degrees read once, y written once; a min and a max per
    compare-exchange of every column."""
    nbytes = (3 * w * p + w * d + w) * 4
    return (*_bound(nbytes, 2 * exchanges * p), nbytes)


def check_robust_gossip(cycles_per_ms: float) -> dict:
    """robust_gossip with ROBUST_MODES on each of ROBUST_CASES, with every
    fifth row sign-flipped in t and rows of degree 0."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, main = 0.0, None
    for case, w, spec, cut, zeroed, p, width in ROBUST_CASES:
        nbr, deg, kind, exchanges = robust_table(w, spec, cut, zeroed, width)
        d = nbr.shape[1]
        instance = f"{kind} D={d}"
        x = torch.randn(w, p, generator=gen, device="cuda")
        t = _lying(x)
        reps = 50 if kind == "register" else 10
        for mode, b in ROBUST_MODES:
            name = f"{case}-{mode}:{b:g}"
            y = ops.robust_gossip(x, t, nbr, deg, b=b, mode=mode)
            err = _require_equal("robust_gossip", name, [
                (y, ref.robust_gossip_ref(x, t, nbr, deg, b=b, mode=mode))])
            for i in (*cut, *zeroed):
                if not torch.equal(y[i], x[i]):
                    raise AssertionError(f"robust_gossip[{name}]: degree-0 "
                                         f"row {i} changed")
            worst = max(worst, err)
            mask = (torch.arange(d, device="cuda")[None, :]
                    < deg[:, None].long())[:, :, None]
            cnt = deg.long() + 1

            def composition(mode=mode, b=b):
                # no single PyTorch call computes it: gather, sort, then
                # the window's masked sum (or the middle pair)
                win = torch.cat([x[:, None], torch.where(
                    mask, t[nbr.long()], float("inf"))], dim=1)
                sv = torch.sort(win, dim=1).values
                if mode == "median":
                    lo = ((cnt - 1) // 2)[:, None, None].expand(w, 1, p)
                    hi = (cnt // 2)[:, None, None].expand(w, 1, p)
                    y = 0.5 * (sv.gather(1, lo) + sv.gather(1, hi))[:, 0]
                else:
                    bi = robust.resolve_trim(b, cnt)
                    pos = torch.arange(d + 1, device="cuda")[None, :, None]
                    inside = (pos >= bi[:, None, None]) & \
                        (pos < (cnt - bi)[:, None, None])
                    y = torch.where(inside, sv, 0.0).sum(dim=1) / \
                        (cnt - 2 * bi).float()[:, None]
                return torch.where((deg > 0)[:, None], y, x)
            comp_err = float((composition() - y).abs().max())
            kernel_ms = time_ms(
                lambda mode=mode, b=b: ops.robust_gossip(x, t, nbr, deg, b=b,
                                                         mode=mode),
                cycles_per_ms, batch=10, reps=reps)
            plain_ms = time_ms(
                lambda mode=mode, b=b: ref.robust_gossip_ref(
                    x, t, nbr, deg, b=b, mode=mode), cycles_per_ms, batch=2,
                reps=reps)
            comp_ms = time_ms(composition, cycles_per_ms, batch=2, reps=reps)
            bound_ms, bound_by, nbytes = robust_bound(w, p, d, exchanges)
            log("phase2", kernel="robust_gossip", case=name,
                instance=repr(instance), W=w, P=p, D=d, bit_equal=True,
                max_abs_err=err, composition_max_abs_diff=comp_err,
                ms=f"{kernel_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
                composition_ms=f"{comp_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
                bound_by=bound_by, bound_mb=f"{nbytes / 1e6:.6f}",
                compare_exchanges=exchanges * p,
                share_of_bound=f"{bound_ms / kernel_ms:.4f}")
            if name == "full30-trimmed:6":
                main = dict(ms=kernel_ms, plain_ms=plain_ms,
                            library_ms=None, bound_ms=bound_ms,
                            bound_by=bound_by)
        del x, t, y
        torch.cuda.empty_cache()
    return dict(name="robust_gossip", route="cuda",
                source="src/repro_torch/kernels/csrc/robust_gossip.cu",
                replaces="src/repro/kernels/robust_gossip.py:101",
                max_abs_err=worst, **main)


# ---------------------------------------------------------------------------
# phase 2: flash attention and consensus distance
# ---------------------------------------------------------------------------

# (case, B, S, Hq, Hkv, hd, causal, window, main), S = Sk: the registry
# path's launches (S = 15, the next-token inputs of 16-token sequences):
# a local SGD step (W = 8 workers x 32 sequences), one group of the
# measurement stack (2 workers x 2,048 sequences: the engines compute the
# stack's gradients 2 workers a pass, ModelAdapter.workers_per_pass; the
# fleet metrics' 8 x 512 sequences are the same B) and the whole stack in
# one launch (8 x 2,048); smollm-360m's train shape, a gemma3-27b local
# layer, a nemotron-4 head width (192) and the forced causal rule
# (non-causal, S not a multiple of 128); the short-sequence kernel's
# dispatch limit at hd 64 (Sk = FLASH_SHORT_MAX_KEYS[64]) and one key
# past it, a non-causal Sk = 128 (a multiple of 128, so no mask is
# forced) and a sliding window inside the short kernel's reach
FLASH_CASES = (("local-step", 256, 15, 15, 5, 64, True, 0, False),
               ("measurement-group", 4096, 15, 15, 5, 64, True, 0, True),
               ("measurement-stack", 16384, 15, 15, 5, 64, True, 0, False),
               ("smollm-train", 2, 4096, 15, 5, 64, True, 0, False),
               ("gemma3-local", 1, 4096, 32, 16, 128, True, 1024, False),
               ("hd192", 1, 1000, 96, 8, 192, True, 0, False),
               ("forced-causal", 4, 100, 6, 2, 64, False, 0, False),
               ("short-limit", 256, ops.FLASH_SHORT_MAX_KEYS[64], 15, 5, 64,
                True, 0, False),
               ("short-limit+1", 256, ops.FLASH_SHORT_MAX_KEYS[64] + 1, 15,
                5, 64, True, 0, False),
               ("noncausal-128", 64, 128, 15, 5, 64, False, 0, False),
               ("short-window", 64, ops.FLASH_SHORT_MAX_KEYS[128], 32, 16,
                128, True, 16, False))


def check_flash_attention(cycles_per_ms: float) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst, main = 0.0, None
    for case, b, s, hq, hkv, hd, causal, window, is_main in FLASH_CASES:
        q = torch.randn(b, s, hq, hd, generator=gen, device="cuda")
        k = torch.randn(b, s, hkv, hd, generator=gen, device="cuda")
        v = torch.randn(b, s, hkv, hd, generator=gen, device="cuda")
        forced = causal or s % 128 != 0
        y = ops.flash_attention(q, k, v, causal=causal, window=window)
        y_ref = ref.flash_attention_ref(q, k, v, causal=forced,
                                        window=window)
        torch.cuda.synchronize()
        diff = (y - y_ref).abs()
        err = float(diff.max())
        if bool((diff > FLASH_ATOL + FLASH_RTOL * y_ref.abs()).any()):
            raise AssertionError(f"flash_attention[{case}] differs from its "
                                 f"plain version: max |diff| = {err}")
        worst = max(worst, err)
        mask = ref.attention_mask(s, s, causal=forced, window=window,
                                  device="cuda")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            # one PyTorch call: scaled_dot_product_attention over the
            # [B, H, S, hd] views, GQA by its own head grouping
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask if window else None,
                is_causal=forced and not window, enable_gqa=True)
        lib_err = float((library().transpose(1, 2) - y_ref).abs().max())
        heavy = s >= 1000
        kernel_ms = time_ms(
            lambda: ops.flash_attention(q, k, v, causal=causal,
                                        window=window), cycles_per_ms,
            batch=2 if heavy else 5, reps=10 if heavy else 30)
        plain_ms = time_ms(
            lambda: ref.flash_attention_ref(q, k, v, causal=forced,
                                            window=window), cycles_per_ms,
            batch=1, reps=5 if heavy else 10)
        library_ms = time_ms(library, cycles_per_ms, batch=2 if heavy else 5,
                             reps=10 if heavy else 30)
        # q, k and v read once, o written once; two products of 2 hd
        # operations per (query, key in reach) pair and query head
        pairs = int(mask.sum())
        nbytes = (2 * b * s * hq * hd + 2 * b * s * hkv * hd) * 4
        flops = 4 * b * hq * hd * pairs
        bound_ms, bound_by = _bound(nbytes, flops)
        tc_ms = max(nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS) * 1e3
        log("phase2", kernel="flash_attention", case=case,
            instance=ops.flash_instance(q, k, v), B=b, S=s, Hq=hq,
            Hkv=hkv, hd=hd, causal=forced, window=window,
            max_abs_err=err, sdpa_max_abs_diff=lib_err,
            ms=f"{kernel_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
            sdpa_ms=f"{library_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
            bound_by=bound_by, tc_bound_ms=f"{tc_ms:.6f}",
            bound_mb=f"{nbytes / 1e6:.6f}", gflop=f"{flops / 1e9:.6f}",
            tflops=f"{flops / kernel_ms / 1e9:.3f}",
            share_of="f32_fma_bound",
            share_of_bound=f"{bound_ms / kernel_ms:.4f}",
            share_of_tc_bound=f"{tc_ms / kernel_ms:.4f}")
        if is_main:
            main = dict(ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
        del q, k, v, y, y_ref, mask
        torch.cuda.empty_cache()
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:77",
                max_abs_err=worst, **main)


def check_consensus_dist(cycles_per_ms: float) -> dict:
    """consensus_dist at the reference kernel benchmark's shape (L = 2^17,
    K = 4) and at the registry path's width (one worker's row against
    its 7 peers' rows, L = 45,228,480), neighbours near x: 1e-6
    relative, and the same bits on a second run."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst, main = 0.0, None
    for case, k, length in (("kernel-bench", 4, 2 ** 17),
                            ("path-width", 7, LM_PARAMS)):
        x = torch.randn(length, generator=gen, device="cuda")
        u = x + 0.1 * torch.randn(k, length, generator=gen, device="cuda")
        d = ops.consensus_dist(x, u)
        d_ref = ref.consensus_dist_ref(x, u)
        rel = float(((d - d_ref).abs() / d_ref).max())
        if rel > CONSENSUS_RTOL or not torch.equal(d, ops.consensus_dist(x,
                                                                         u)):
            raise AssertionError(f"consensus_dist[{case}]: relative "
                                 f"difference {rel} or not repeatable")
        err = float((d - d_ref).abs().max())
        worst = max(worst, err)

        def library():
            return torch.linalg.vector_norm(u - x, dim=1)
        lib_rel = float(((library() - d_ref).abs() / d_ref).max())
        kernel_ms = time_ms(lambda: ops.consensus_dist(x, u), cycles_per_ms,
                            batch=5, reps=20)
        plain_ms = time_ms(lambda: ref.consensus_dist_ref(x, u),
                           cycles_per_ms, batch=2, reps=10)
        library_ms = time_ms(library, cycles_per_ms, batch=2, reps=10)
        # x and u read once, the K distances written once; a subtract, a
        # multiply and an add per element of u
        nbytes = ((k + 1) * length + k) * 4
        bound_ms, bound_by = _bound(nbytes, 3 * k * length)
        log("phase2", kernel="consensus_dist", case=case, K=k, L=length,
            max_rel_err=rel, max_abs_err=err, vector_norm_max_rel_diff=lib_rel,
            ms=f"{kernel_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
            vector_norm_ms=f"{library_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
            bound_by=bound_by, bound_mb=f"{nbytes / 1e6:.6f}")
        if case == "path-width":
            main = dict(ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
        del x, u
        torch.cuda.empty_cache()
    return dict(name="consensus_dist", route="cuda",
                source="src/repro_torch/kernels/csrc/consensus_dist.cu",
                replaces="src/repro/kernels/consensus_dist.py:37",
                max_abs_err=worst, **main)


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

def _expected_launches(algo: str, cfg: FedHPConfig,
                       hist) -> dict[str, int]:
    """What a fused run must launch, per communicating round (per event
    for AD-PSGD, where every round holds W events) and nothing else:

    - trimmed/median (dense or sparse gossip): one robust_gossip;
    - attackers without a robust mode: one gossip_mix (dense) or one
      gossip_edges (sparse) over the lying wire;
    - a codec: one quantize and one dequantize under int8, one sparsify
      under top-k and rand-k, and under sparse gossip one gossip_edges
      for the mixing delta;
    - honest and uncompressed: one gossip_mix (dense) or gossip_edges
      (sparse);
    - AD-PSGD: one gossip_mix per event uncompressed, over a lying wire
      or screened (both endpoints' rows in one launch), the codec's
      kernels under a codec."""
    arr = hist.as_arrays()
    n = (len(hist.records) * cfg.num_workers if algo == "adpsgd"
         else int((arr["num_links"] > 0).sum()))
    sparse = cfg.gossip == "sparse" and algo != "adpsgd"
    mix = ("gossip_edges",) if sparse else ("gossip_mix",)
    kind = cfg.compress.partition(":")[0]
    if cfg.robust in ("none", "") or cfg.robust.startswith("screen"):
        names = {"none": ("gossip_mix",) if algo == "adpsgd" else mix,
                 "int8": ("quantize_block", "dequantize_block")}.get(
                     kind, ("sparsify_block",))
        if kind != "none" and sparse:
            names += ("gossip_edges",)
    else:
        names = ("robust_gossip",)
    return {k: n if k in names else 0 for k in ops.LAUNCHES}


def _label(algo: str, fields: dict) -> str:
    """algo/field=value/...: the attackers by their count, the signflip
    default and the Byzantine legs' tau 4 left out."""
    parts = [algo]
    for k, v in fields.items():
        if k == "byzantine":
            parts.append(f"byzantine={len(v)}")
        elif (k, v) not in (("byzantine_attack", "signflip"),
                            ("tau_init", 4)):
            parts.append(f"{k}={v}")
    return "/".join(parts)


def _timed_run(algo: str, cfg: FedHPConfig, rounds: int, warmup: int,
               **kw):
    """A warm-up run, then the timed run with the launch counters zeroed
    just before it and read just after -> (history, seconds, counts)."""
    # warm-up: the first use of cuBLAS and autograd on the card is not
    # the algorithm's (rounds/s below still include set-up)
    run_algorithm(algo, cfg, rounds=warmup, fused=True, **kw)
    torch.cuda.synchronize()
    for counts in (ops.LAUNCHES, ops.INSTANCE_LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    hist = run_algorithm(algo, cfg, rounds=rounds, fused=True, **kw)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return hist, elapsed, dict(ops.LAUNCHES)


def _check_run(name: str, algo: str, cfg: FedHPConfig, rounds: int, hist,
               counts: dict) -> None:
    expected = _expected_launches(algo, cfg, hist)
    if counts != expected:
        raise AssertionError(f"{name}: launched {counts}, the path must "
                             f"launch {expected}")
    inst = ops.INSTANCE_LAUNCHES
    if sum(v for k, v in inst.items() if k.startswith("robust_gossip:")) \
            != counts["robust_gossip"]:
        raise AssertionError(f"{name}: robust_gossip instances {inst} do "
                             f"not add up to {counts['robust_gossip']}")
    # a round whose plan has a worker of degree past 64 (round 0 of a
    # complete base of 70) takes the wide instance, registers and shuffles
    if cfg.num_workers - 1 > ops.ROBUST_REGISTER_MAX_DEGREE and \
            cfg.base_topology == "full" and cfg.robust not in ("none", "") \
            and inst["robust_gossip:wide"] == 0:
        raise AssertionError(f"{name}: the wide robust_gossip instance "
                             "never launched")
    _check_history(name, cfg, rounds, hist)


def _check_history(name: str, cfg: FedHPConfig, rounds: int, hist) -> None:
    """The run's records: as many as its rounds, finite metrics, finite
    final parameters of every worker, and rejections where it screens."""
    arr = hist.as_arrays()
    if len(hist.records) != rounds:
        raise AssertionError(f"{name}: {len(hist.records)} records")
    for key in ("accuracy", "loss", "consensus"):
        if not np.isfinite(arr[key]).all():
            raise AssertionError(f"{name}: non-finite {key}")
    for leaf_name, leaf in hist.final_params.items():
        if leaf.shape[0] != cfg.num_workers or \
                not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"{name}: bad final {leaf_name}")
    if cfg.robust.startswith("screen") and not sum(hist.screen_rejects):
        raise AssertionError(f"{name}: screening rejected nothing")


def run_main_path() -> dict[str, int]:
    """Phase 3; returns the launches of each kernel summed over the
    timed runs."""
    total = {k: 0 for k in ops.LAUNCHES}
    legs = [(algo, fields, replace(PAPER_CFG, **fields), MAIN_ROUNDS,
             WARMUP_ROUNDS, PAPER_KW) for algo, fields in MAIN_PATHS]
    legs.append(("dpsgd", dict(num_workers=2048, **SPARSE), BIG_CFG,
                 BIG_ROUNDS, 1, BIG_KW))
    legs.append(("fedhp", WIDE_FIELDS, replace(PAPER_CFG, **WIDE_FIELDS),
                 WIDE_ROUNDS, 1, PAPER_KW))
    for algo, fields, cfg, rounds, warmup, kw in legs:
        name = _label(algo, fields)
        hist, elapsed, counts = _timed_run(algo, cfg, rounds, warmup, **kw)
        _check_run(name, algo, cfg, rounds, hist, counts)
        for k in total:
            total[k] += counts[k]
        arr = hist.as_arrays()
        extra = ({} if hist.screen_rejects is None
                 else dict(screen_rejects=hist.screen_rejects))
        if counts["robust_gossip"]:
            extra["robust_instances"] = {
                k.split(":")[1]: v for k, v in ops.INSTANCE_LAUNCHES.items()
                if k.startswith("robust_gossip")}
        log("phase3", path=name, rounds=rounds,
            comm_rounds=int((arr["num_links"] > 0).sum()),
            launches={k: v for k, v in counts.items() if v},
            rounds_per_s=f"{rounds / elapsed:.3f}",
            seconds_per_round=f"{elapsed / rounds:.4f}",
            seconds=f"{elapsed:.3f}",
            final_accuracy=f"{hist.final_accuracy:.6f}",
            final_loss=f"{arr['loss'][-1]:.6f}",
            sim_time=f"{arr['cumulative_time'][-1]:.3f}", **extra)
    return total


class _PlanRecorder:
    """Wraps a strategy and keeps each round's taus as the engines apply
    them (clipped to [1, tau_max] on the alive workers, 0 elsewhere)."""

    def __init__(self, inner, tau_max: int):
        self.inner = inner
        self.name = inner.name
        self.adaptive = getattr(inner, "adaptive", False)
        self.tau_max = tau_max
        self.taus: list[np.ndarray] = []

    def plan(self, h, alive=None):
        p = self.inner.plan(h, alive=alive)
        live = np.ones(len(p.taus), bool) if alive is None else alive
        self.taus.append(np.where(live, np.clip(p.taus, 1, self.tau_max), 0))
        return p

    def observe(self, h, **kw):
        self.inner.observe(h, **kw)


def _pow2(v: int) -> int:
    return 1 << (v - 1).bit_length() if v > 1 else 1


def _lm_forwards(adapter, cfg: FedHPConfig, taus: list[np.ndarray],
                 adaptive: bool) -> int:
    """The model forward passes a fused run must make (fused.py's
    _scan_segment): per round its segment's tau extent (the largest tau
    of the segment, rounded up to a power of two; a segment is one round
    for an adaptive strategy, the whole run here for a static one) of
    local SGD steps, the fleet metrics' accuracy and loss, and for an
    adaptive strategy the three measurement gradients (the eval stack
    twice, the probe once); a gradient pass on a batch runs in
    ceil(W / workers_per_pass) groups of workers."""
    w, s = cfg.num_workers, adapter.seq_len

    def groups(*shape):
        x = torch.zeros(1, dtype=torch.int32).expand(*shape)
        return -(-w // adapter.workers_per_pass(x))

    local = groups(w, cfg.batch_size, s)
    measure = 2 * groups(w, w, 256, s) + groups(w, w, 32, s)
    caps = ([_pow2(int(max(t.max(), 1))) for t in taus] if adaptive else
            [_pow2(int(max(max(t.max() for t in taus), 1)))] * len(taus))
    return sum(cap * local + 2 + (measure if adaptive else 0)
               for cap in caps)


def _lm_data():
    """The registry path's corpus, test split and shards, once: from the
    spec through the user's entry point (``setup_experiment``)."""
    t0 = time.perf_counter()
    train, tx, ty, shards, _ = setup_experiment(LM_CFG, device="cuda",
                                                **LM_KW)
    return (train, tx, ty, shards), time.perf_counter() - t0


def _lm_run(adapter, data, algo: str, rounds: int, *, fused_engine: bool,
            **fields):
    """One registry-path run from a fresh cluster (which prices a model
    transfer at the trained model's size) and strategy -> (history, the
    recorded taus)."""
    cfg = replace(LM_CFG, algorithm=algo, **fields)
    train, tx, ty, shards = data
    cluster = SimCluster(cfg.num_workers, model_bits=adapter.model_bits,
                         seed=cfg.seed)
    strategy = _PlanRecorder(make_strategy(cfg, topo.make_base_topology(
        cfg.num_workers, cfg.base_topology, cfg.seed)), cfg.tau_max)
    run = fused.run_dfl_fused if fused_engine else engine.run_dfl
    hist = run(train, tx, ty, shards, cluster, cfg, strategy, rounds=rounds,
               adapter=adapter, device="cuda")
    return hist, strategy.taus


def lm_adapter():
    adapter = modelspec.RegistryAdapter(LM_MODEL, LM_SEQ, LM_CLASSES,
                                        spec="smollm-360m:layers=4,"
                                             "vocab=6144,flash")
    if adapter.param_count != LM_PARAMS:
        raise AssertionError(f"registry path: P = {adapter.param_count}")
    return adapter


def run_lm_path(adapter, data) -> dict[str, int]:
    """Phase 3's registry path: FedHP and D-PSGD through the fused
    engine, a warm-up run and then the timed run, each held to exactly
    the flash_attention launches (layers x forward passes) and gossip_mix
    launches (communicating rounds) the path must make."""
    total = {k: 0 for k in ops.LAUNCHES}
    for algo in ("fedhp", "dpsgd"):
        _lm_run(adapter, data, algo, LM_WARMUP_ROUNDS, fused_engine=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        hist, taus = _lm_run(adapter, data, algo, LM_ROUNDS,
                             fused_engine=True)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        arr = hist.as_arrays()
        adaptive = algo == "fedhp"
        forwards = _lm_forwards(adapter, LM_CFG, taus, adaptive)
        expected = {k: 0 for k in ops.LAUNCHES}
        expected["flash_attention"] = LM_MODEL.num_layers * forwards
        expected["gossip_mix"] = int((arr["num_links"] > 0).sum())
        name = f"{algo}/smollm-360m-4l"
        if counts != expected:
            raise AssertionError(f"{name}: launched {counts}, the path must "
                                 f"launch {expected}")
        _check_history(name, LM_CFG, LM_ROUNDS, hist)
        for k in total:
            total[k] += counts[k]
        log("phase3", path=name, rounds=LM_ROUNDS, P=adapter.param_count,
            launches={k: v for k, v in counts.items() if v},
            forward_passes=forwards,
            seconds_per_round=f"{elapsed / LM_ROUNDS:.4f}",
            seconds=f"{elapsed:.3f}",
            first_accuracy=f"{arr['accuracy'][0]:.9f}",
            last_accuracy=f"{arr['accuracy'][-1]:.9f}",
            first_loss=f"{arr['loss'][0]:.7f}",
            last_loss=f"{arr['loss'][-1]:.7f}",
            mean_tau=arr["mean_tau"].tolist(),
            num_links=arr["num_links"].tolist(),
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    return total


def check_lm_engines_agree(adapter, data) -> None:
    """Phase 4 on the registry path: FedHP through both engines."""
    hists, secs = {}, {}
    for fused_engine in (False, True):
        t0 = time.perf_counter()
        hists[fused_engine], _ = _lm_run(adapter, data, "fedhp", LM_ROUNDS,
                                         fused_engine=fused_engine,
                                         **LM_PARITY_FIELDS)
        torch.cuda.synchronize()
        secs[fused_engine] = time.perf_counter() - t0
    _compare_engines("fedhp/smollm-360m-4l/erdos:0.5", hists, secs,
                     int8=False, rounds=LM_ROUNDS)


def check_engines_agree() -> None:
    """Phase 4: each PARITY_PATHS run through both engines."""
    for algo, fields in PARITY_PATHS:
        cfg = replace(PAPER_CFG, replan_every=1, **fields)
        hists, secs = {}, {}
        for fused_engine in (False, True):
            t0 = time.perf_counter()
            hists[fused_engine] = run_algorithm(
                algo, cfg, rounds=PARITY_ROUNDS, fused=fused_engine,
                **PAPER_KW)
            secs[fused_engine] = time.perf_counter() - t0
        _compare_engines(_label(algo, fields), hists, secs,
                         int8=cfg.compress == "int8", rounds=PARITY_ROUNDS)


def _compare_engines(name: str, hists: dict, secs: dict, *, int8: bool,
                     rounds: int) -> None:
    """Reference (``hists[False]``) against fused (``hists[True]``): host
    fields and rejection counts equal, device metrics within the tests'
    tolerances; logs the differences."""
    a, b = hists[False].as_arrays(), hists[True].as_arrays()
    for k in EXACT:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{name}: host field {k} differs: "
                                 f"{a[k]} vs {b[k]}")
    if hists[False].screen_rejects != hists[True].screen_rejects:
        raise AssertionError(
            f"{name}: screen rejections differ: "
            f"{hists[False].screen_rejects} vs "
            f"{hists[True].screen_rejects}")
    acc = float(np.abs(a["accuracy"] - b["accuracy"]).max())
    rel = {k: float((np.abs(a[k] - b[k])
                     / np.maximum(np.abs(a[k]), 1e-12)).max())
           for k in ("loss", "consensus")}
    np.testing.assert_allclose(a["accuracy"], b["accuracy"], rtol=0,
                               atol=ACC_ATOL, err_msg=name)
    np.testing.assert_allclose(a["loss"], b["loss"], err_msg=name,
                               rtol=INT8_LOSS_RTOL if int8 else REL_TOL)
    np.testing.assert_allclose(
        a["consensus"], b["consensus"], atol=CONSENSUS_ATOL,
        rtol=INT8_CONSENSUS_RTOL if int8 else REL_TOL, err_msg=name)
    # how far apart the engines' final parameters are (the reference
    # mixes as sum_j w_ij x_j, the kernel as x_i + sum_j w_ij (x_j - x_i))
    param_diff = max(float((hists[False].final_params[k].double()
                            - hists[True].final_params[k].double())
                           .abs().max())
                     for k in hists[False].final_params)
    # the rounds that pass only through the absolute term, with both
    # engines' consensus values there
    cdiff = np.abs(a["consensus"] - b["consensus"])
    worst = int(np.argmax(cdiff))
    abs_only = np.nonzero(cdiff > REL_TOL * np.abs(b["consensus"]))[0]
    extra = ({} if hists[True].screen_rejects is None
             else dict(screen_rejects=hists[True].screen_rejects))
    log("phase4", path=name, rounds=rounds,
        host_fields_equal=True, acc_max_abs_diff=acc,
        loss_max_rel_diff=rel["loss"],
        consensus_max_rel_diff=rel["consensus"],
        consensus_max_abs_diff=float(cdiff[worst]), at_round=worst,
        consensus_there=[float(a["consensus"][worst]),
                         float(b["consensus"][worst])],
        rounds_admitted_by_atol=abs_only.tolist(),
        param_max_abs_diff=param_diff,
        reference_s=f"{secs[False]:.3f}", fused_s=f"{secs[True]:.3f}",
        mean_tau=a["mean_tau"].tolist(),
        num_links=a["num_links"].tolist(), **extra)


def trace_lm_rounds(adapter, data) -> None:
    """One traced round of each registry-path algorithm: the device's
    busy time (the sum of its kernels' times; one stream, so they do not
    overlap) against the round's wall time, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    for algo in ("fedhp", "dpsgd"):
        _lm_run(adapter, data, algo, 1, fused_engine=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _lm_run(adapter, data, algo, 1, fused_engine=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: e.self_device_time_total,
                     reverse=True)[:15]
        log("trace", path=f"{algo}/smollm-360m-4l", rounds=1,
            wall_s=f"{wall:.4f}", device_busy_s=f"{busy_us / 1e6:.4f}",
            idle_share=f"{1 - busy_us / 1e6 / wall:.4f}",
            kernels=len(kernels))
        # the top kernels, then the port's own wherever they rank
        ours = [e for e in kernels if e not in top and any(
            f"{name}_kernel" in e.key or f"{name}_f32" in e.key
            for name in ("gossip_mix", "quantize", "dequantize", "sparsify",
                         "gossip_edges", "robust_gossip", "flash_fwd",
                         "flash_short", "consensus"))]
        for e in top + ours:
            log("trace", kernel=repr(e.key[:90]), calls=e.count,
                device_ms=f"{e.self_device_time_total / 1e3:.3f}",
                share=f"{e.self_device_time_total / busy_us:.4f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    lib, nvcc_log = ops.build()
    build_s = time.perf_counter() - t0
    if sys.argv[1:] == ["--trace"]:
        log("trace", card=repr(card), build_s=f"{build_s:.3f}")
        adapter = lm_adapter()
        data, _ = _lm_data()
        trace_lm_rounds(adapter, data)
        return 0
    ptxas = [ln.strip() for ln in nvcc_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("phase1", card=repr(card), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=f"{build_s:.3f}",
        library=lib.name, ptxas=ptxas)

    cycles_per_ms = _sleep_cycles_per_ms()
    launch_floor(cycles_per_ms)
    kernels = [check_gossip_mix(cycles_per_ms), *check_codecs(cycles_per_ms),
               check_gossip_edges(cycles_per_ms),
               check_robust_gossip(cycles_per_ms),
               check_flash_attention(cycles_per_ms),
               check_consensus_dist(cycles_per_ms)]
    launches = run_main_path()
    adapter = lm_adapter()
    data, data_s = _lm_data()
    log("phase3", registry_corpus=LM_SPEC, setup_s=f"{data_s:.3f}",
        sequences=len(data[0].x) + len(data[1]))
    for k, v in run_lm_path(adapter, data).items():
        launches[k] += v
    for kernel in kernels:
        kernel["launches"] = launches[kernel["name"]]
        if kernel["name"] in OFF_PATH:
            if kernel["launches"]:
                raise AssertionError(f"{kernel['name']} launched on the main "
                                     "path, which has no call to it")
        elif kernel["launches"] == 0:
            raise AssertionError(f"{kernel['name']} never launched on the "
                                 "main path")
    check_engines_agree()
    check_lm_engines_agree(adapter, data)

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{k: kernel[k] for k in order}
                                  for kernel in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
