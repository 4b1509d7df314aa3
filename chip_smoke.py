"""GPU smoke run of the PyTorch port (``src/repro_torch``): the quickest
proof that the port builds, launches its kernels and runs its main path
on an NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is non-zero):

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   ``nvcc`` compiles ``src/repro_torch/kernels/csrc`` for sm_90a, one
   process per source started together;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes and a few others — bit-equality required — with
   CUDA-event times of the kernel, the plain version and the nearest
   PyTorch library call computing the same function: ``gossip_mix``,
   then the wire codecs' ``quantize_block``, ``dequantize_block`` and
   ``sparsify_block`` (a top-k gate per row, and rand-k's shared row);
3. the main path: ``run_algorithm(algo, cfg, fused=True)`` at the
   paper's fleet (30 workers) and MLP (P = 6,922) — FedHP and the
   synchronous baselines uncompressed, FedHP and D-PSGD under int8,
   top-k and rand-k, AD-PSGD uncompressed and under int8 — each after a
   short warm-up run, with the launch counters zeroed before each timed
   run and read after it, and held to what the path must launch;
4. the reference engine against the fused engine on the card — FedHP
   uncompressed, under int8 and under top-k, AD-PSGD uncompressed and
   under int8: host record fields equal, device metrics within the
   tests' tolerances (int8's wider, ``tests/test_torch_codec_engine.py``).

Then a JSON line describing every kernel, the card line, and the last
line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, without a CUDA device or outside a checkout of the repo.
"""
from __future__ import annotations

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

from repro_torch.configs.base import FedHPConfig  # noqa: E402
from repro_torch.core import compression  # noqa: E402
from repro_torch.core import topology as topo  # noqa: E402
from repro_torch.core.experiment import run_algorithm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside
# the tensor cores — the bound of a kernel is the larger of its bytes
# over the first and its operations over the second
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# the paper's configuration (benchmarks/run.py of the reference)
PAPER_CFG = FedHPConfig(num_workers=30, tau_init=8, tau_max=30, lr=0.15,
                        lr_decay=0.993, batch_size=32, seed=5)
PAPER_KW = dict(non_iid_p=0.4, spread=3.0)
# the main path's runs: (algorithm, cfg.compress)
MAIN_PATHS = (("fedhp", "none"), ("dpsgd", "none"), ("ldsgd", "none"),
              ("pens", "none"), ("fedhp", "int8"), ("fedhp", "topk:0.1"),
              ("fedhp", "randk:0.1"), ("dpsgd", "int8"),
              ("dpsgd", "topk:0.1"), ("dpsgd", "randk:0.1"),
              ("adpsgd", "none"), ("adpsgd", "int8"))
PARITY_PATHS = (("fedhp", "none"), ("fedhp", "int8"), ("fedhp", "topk:0.1"),
                ("adpsgd", "none"), ("adpsgd", "int8"))
MAIN_ROUNDS = 20
WARMUP_ROUNDS = 2
PARITY_ROUNDS = 10

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
        rng = np.random.default_rng(7)
        adj = topo.erdos_topology(b, 0.3, rng)
        dead = rng.choice(b, 3, replace=False)
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


def check_gossip_mix(cycles_per_ms: float) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("main", 30, 30, 6922, True), ("aligned", 30, 30, 8192, False),
             ("short", 30, 30, 1000, False), ("adpsgd", 1, 1, 6922, False)]
    worst = 0.0
    main = None
    for name, b, k, length, is_main in cases:
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
        kernel_ms = time_ms(lambda: ops.gossip_mix(x, u, w), cycles_per_ms,
                            batch=10)
        # the plain version is 3 K launches per call
        plain_ms = time_ms(lambda: ref.gossip_mix_ref(x, u, w),
                           cycles_per_ms, batch=2)
        library_ms = time_ms(library, cycles_per_ms, batch=10)
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
            bound_mb=f"{nbytes / 1e6:.6f}")
        if is_main:
            main = dict(ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
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


def check_codecs(cycles_per_ms: float) -> list[dict]:
    """quantize_block, dequantize_block and sparsify_block at the main
    path's [30, 6922] (one tile per worker), AD-PSGD's pair [2, 6922],
    [30, 100000] (13 tiles, the last ragged) and [30, 1000]."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [("main", 30, 6922), ("adpsgd", 2, 6922),
             ("tiles", 30, 100000), ("short", 30, 1000)]
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

    for case, w, p in cases:
        x = 0.3 * torch.randn(w, p, generator=gen, device="cuda")
        row_len, tile_len, n_tiles = ref.wire_tiles(p)
        shape = dict(W=w, P=p, tiles=n_tiles)

        q, scales = ops.quantize_block(x)
        err = _require_equal("quantize_block", case,
                             zip((q, scales), ref.quantize_block_ref(x)))
        # x read once, q (the padded wire row) and the scales written
        # once; abs, max, divide, round and clamp per element
        main = record("quantize_block", case, err,
                      lambda: ops.quantize_block(x),
                      lambda: ref.quantize_block_ref(x), None,
                      4 * w * p + w * row_len + 4 * w * n_tiles,
                      6 * w * p, **shape)
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


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

def _expected_launches(algo: str, compress: str, hist) -> dict[str, int]:
    """What a fused run must launch: per communicating round (per event
    for AD-PSGD, where every round holds W events), one gossip_mix
    uncompressed, one quantize and one dequantize under int8, one
    sparsify under top-k and rand-k — and nothing else."""
    arr = hist.as_arrays()
    n = (len(hist.records) * PAPER_CFG.num_workers if algo == "adpsgd"
         else int((arr["num_links"] > 0).sum()))
    kind = compress.partition(":")[0]
    names = {"none": ("gossip_mix",),
             "int8": ("quantize_block", "dequantize_block")}.get(
                 kind, ("sparsify_block",))
    return {k: n if k in names else 0 for k in ops.LAUNCHES}


def run_main_path() -> dict[str, int]:
    """Phase 3; returns the launches of each kernel summed over the
    timed runs."""
    total = {k: 0 for k in ops.LAUNCHES}
    for algo, compress in MAIN_PATHS:
        cfg = replace(PAPER_CFG, compress=compress)
        # warm-up: the first use of cuBLAS and autograd on the card is not
        # the algorithm's (rounds/s below still include set-up)
        run_algorithm(algo, cfg, rounds=WARMUP_ROUNDS, fused=True,
                      **PAPER_KW)
        torch.cuda.synchronize()
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        hist = run_algorithm(algo, cfg, rounds=MAIN_ROUNDS, fused=True,
                             **PAPER_KW)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        arr = hist.as_arrays()
        if len(hist.records) != MAIN_ROUNDS:
            raise AssertionError(f"{algo}/{compress}: "
                                 f"{len(hist.records)} records")
        expected = _expected_launches(algo, compress, hist)
        if counts != expected:
            raise AssertionError(f"{algo}/{compress}: launched {counts}, "
                                 f"the path must launch {expected}")
        for key in ("accuracy", "loss", "consensus"):
            if not np.isfinite(arr[key]).all():
                raise AssertionError(f"{algo}/{compress}: non-finite {key}")
        for name, leaf in hist.final_params.items():
            if leaf.shape[0] != PAPER_CFG.num_workers or \
                    not bool(torch.isfinite(leaf).all()):
                raise AssertionError(f"{algo}/{compress}: bad final {name}")
        for k in total:
            total[k] += counts[k]
        log("phase3", algo=algo, compress=compress, rounds=MAIN_ROUNDS,
            comm_rounds=int((arr["num_links"] > 0).sum()), launches=counts,
            rounds_per_s=f"{MAIN_ROUNDS / elapsed:.3f}",
            seconds=f"{elapsed:.3f}",
            final_accuracy=f"{hist.final_accuracy:.6f}",
            final_loss=f"{arr['loss'][-1]:.6f}",
            sim_time=f"{arr['cumulative_time'][-1]:.3f}")
    return total


def check_engines_agree() -> None:
    """Phase 4: each PARITY_PATHS run through both engines."""
    for algo, compress in PARITY_PATHS:
        cfg = replace(PAPER_CFG, replan_every=1, compress=compress)
        runs, secs = {}, {}
        for fused in (False, True):
            t0 = time.perf_counter()
            runs[fused] = run_algorithm(algo, cfg, rounds=PARITY_ROUNDS,
                                        fused=fused, **PAPER_KW).as_arrays()
            secs[fused] = time.perf_counter() - t0
        a, b = runs[False], runs[True]
        name = f"{algo}/{compress}"
        for k in EXACT:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"{name}: host field {k} differs: "
                                     f"{a[k]} vs {b[k]}")
        int8 = compress == "int8"
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
        # the rounds that pass only through the absolute term, with both
        # engines' consensus values there
        cdiff = np.abs(a["consensus"] - b["consensus"])
        worst = int(np.argmax(cdiff))
        abs_only = np.nonzero(cdiff > REL_TOL * np.abs(b["consensus"]))[0]
        log("phase4", algo=algo, compress=compress, rounds=PARITY_ROUNDS,
            host_fields_equal=True, acc_max_abs_diff=acc,
            loss_max_rel_diff=rel["loss"],
            consensus_max_rel_diff=rel["consensus"],
            consensus_max_abs_diff=float(cdiff[worst]), at_round=worst,
            consensus_there=[float(a["consensus"][worst]),
                             float(b["consensus"][worst])],
            rounds_admitted_by_atol=abs_only.tolist(),
            reference_s=f"{secs[False]:.3f}", fused_s=f"{secs[True]:.3f}",
            mean_tau=a["mean_tau"].tolist(),
            num_links=a["num_links"].tolist())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    lib, nvcc_log = ops.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in nvcc_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("phase1", card=repr(card), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=f"{build_s:.3f}",
        library=lib.name, ptxas=ptxas)

    cycles_per_ms = _sleep_cycles_per_ms()
    kernels = [check_gossip_mix(cycles_per_ms), *check_codecs(cycles_per_ms)]
    launches = run_main_path()
    for kernel in kernels:
        kernel["launches"] = launches[kernel["name"]]
        if kernel["launches"] == 0:
            raise AssertionError(f"{kernel['name']} never launched on the "
                                 "main path")
    check_engines_agree()

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
