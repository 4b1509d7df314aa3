"""GPU smoke run of the PyTorch port (``src/repro_torch``): the quickest
proof that the port builds, launches its kernels and runs its main path
on an NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is non-zero):

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   ``nvcc`` compiles ``src/repro_torch/kernels/csrc`` for sm_90a;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes and a few others — bit-equality required — with
   CUDA-event times of the kernel, the plain version and one PyTorch
   library call computing the same function;
3. the main path: ``run_algorithm(algo, cfg, fused=True)`` for FedHP and
   the synchronous baselines at the paper's fleet (30 workers) and MLP
   (P = 6,922), each after a short warm-up run, with the launch counters
   zeroed before each timed run and read after it;
4. FedHP through the reference engine against the fused engine on the
   card: host record fields equal, device metrics within the tests'
   tolerance, and the consensus values of the rounds that pass only
   through the absolute tolerance.

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
ALGOS = ("fedhp", "dpsgd", "ldsgd", "pens")
MAIN_ROUNDS = 20
WARMUP_ROUNDS = 2
PARITY_ROUNDS = 10

# reference vs fused on the card: the tests' tolerances
# (tests/test_torch_engine.py) — host fields exact; accuracy to one
# eval sample, loss and consensus to 1e-4 relative
EXACT = ("round", "round_time", "waiting_time", "mean_tau", "num_links",
         "cumulative_time")
ACC_ATOL = 1.0 / 512
REL_TOL = 1e-4
CONSENSUS_ATOL = 1e-6


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
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
        log("phase2", kernel="gossip_mix", case=name, B=b, K=k, L=length,
            bit_equal=True, max_abs_err=err, addmm_max_abs_diff=lib_err,
            ms=f"{kernel_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
            addmm_ms=f"{library_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
            bound_mb=f"{nbytes / 1e6:.6f}")
        if is_main:
            main = dict(ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bound_ms,
                        bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / F32_FLOPS else "operations")
    return dict(name="gossip_mix", route="cuda",
                source="src/repro_torch/kernels/csrc/gossip_mix.cu",
                replaces="src/repro/kernels/gossip_mix.py:45",
                max_abs_err=worst, **main)


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

def run_main_path() -> int:
    launches = 0
    for algo in ALGOS:
        # warm-up: the first use of cuBLAS and autograd on the card is not
        # the algorithm's (rounds/s below still include set-up)
        run_algorithm(algo, PAPER_CFG, rounds=WARMUP_ROUNDS, fused=True,
                      **PAPER_KW)
        torch.cuda.synchronize()
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        hist = run_algorithm(algo, PAPER_CFG, rounds=MAIN_ROUNDS, fused=True,
                             **PAPER_KW)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        arr = hist.as_arrays()
        comm_rounds = int((arr["num_links"] > 0).sum())
        if len(hist.records) != MAIN_ROUNDS:
            raise AssertionError(f"{algo}: {len(hist.records)} records")
        if counts["gossip_mix"] < comm_rounds:
            raise AssertionError(
                f"{algo}: gossip_mix launched {counts['gossip_mix']} times "
                f"over {comm_rounds} communicating rounds")
        for key in ("accuracy", "loss", "consensus"):
            if not np.isfinite(arr[key]).all():
                raise AssertionError(f"{algo}: non-finite {key}")
        for name, leaf in hist.final_params.items():
            if leaf.shape[0] != PAPER_CFG.num_workers or \
                    not bool(torch.isfinite(leaf).all()):
                raise AssertionError(f"{algo}: bad final {name}")
        launches += counts["gossip_mix"]
        log("phase3", algo=algo, rounds=MAIN_ROUNDS,
            comm_rounds=comm_rounds, launches=counts,
            rounds_per_s=f"{MAIN_ROUNDS / elapsed:.3f}",
            seconds=f"{elapsed:.3f}",
            final_accuracy=f"{hist.final_accuracy:.6f}",
            final_loss=f"{arr['loss'][-1]:.6f}")
    return launches


def check_engines_agree() -> None:
    cfg = replace(PAPER_CFG, replan_every=1)
    runs = {}
    for fused in (False, True):
        t0 = time.perf_counter()
        runs[fused] = run_algorithm("fedhp", cfg, rounds=PARITY_ROUNDS,
                                    fused=fused, **PAPER_KW).as_arrays()
        runs[f"s{fused}"] = time.perf_counter() - t0
    a, b = runs[False], runs[True]
    plan_diff = np.nonzero((a["mean_tau"] != b["mean_tau"])
                           | (a["num_links"] != b["num_links"]))[0]
    if plan_diff.size:
        raise AssertionError(
            f"fedhp plans diverge between the engines from round "
            f"{int(plan_diff[0])}: mean_tau {a['mean_tau']} vs "
            f"{b['mean_tau']}, num_links {a['num_links']} vs "
            f"{b['num_links']}")
    for k in EXACT:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"host field {k} differs: {a[k]} vs {b[k]}")
    acc = float(np.abs(a["accuracy"] - b["accuracy"]).max())
    rel = {k: float((np.abs(a[k] - b[k])
                     / np.maximum(np.abs(a[k]), 1e-12)).max())
           for k in ("loss", "consensus")}
    np.testing.assert_allclose(a["accuracy"], b["accuracy"], rtol=0,
                               atol=ACC_ATOL)
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=REL_TOL)
    np.testing.assert_allclose(a["consensus"], b["consensus"],
                               rtol=REL_TOL, atol=CONSENSUS_ATOL)
    # the rounds that pass only through the absolute term, with both
    # engines' consensus values there
    cdiff = np.abs(a["consensus"] - b["consensus"])
    worst = int(np.argmax(cdiff))
    abs_only = np.nonzero(cdiff > REL_TOL * np.abs(b["consensus"]))[0]
    log("phase4", algo="fedhp", rounds=PARITY_ROUNDS, host_fields_equal=True,
        acc_max_abs_diff=acc, loss_max_rel_diff=rel["loss"],
        consensus_max_rel_diff=rel["consensus"],
        consensus_max_abs_diff=float(cdiff[worst]), at_round=worst,
        consensus_there=[float(a["consensus"][worst]),
                         float(b["consensus"][worst])],
        rounds_admitted_by_atol=abs_only.tolist(),
        consensus_reference=a["consensus"].tolist(),
        consensus_fused=b["consensus"].tolist(),
        reference_s=f"{runs['sFalse']:.3f}", fused_s=f"{runs['sTrue']:.3f}",
        mean_tau=a["mean_tau"].tolist(), num_links=a["num_links"].tolist())


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

    kernel = check_gossip_mix(_sleep_cycles_per_ms())
    kernel["launches"] = run_main_path()
    check_engines_agree()

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{k: kernel[k] for k in order}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
