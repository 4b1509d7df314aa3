#!/usr/bin/env python3
"""Time the port's ``gossip_mix``, ``flash_attention``, ``robust_gossip``,
``quantize_block`` and ``dequantize_block`` kernels against another
version of their CUDA sources, on one card, in turns.

    python3 tools/kernel_ab.py --base DIR [--out FILE] \
        [--kernels mix flash robust quant dequant]

``DIR`` holds the other version's sources of the kernels named by
``--kernels`` (``gossip_mix.cu``, ``flash_attention.cu``,
``robust_gossip.cu``, ``quantize_block.cu`` for both codec kernels;
for example written there from a git revision with ``git show
REV:src/repro_torch/kernels/csrc/gossip_mix.cu``; 3c12770 or later: a
launcher whose argument list changed since exports ``<launcher>_abi()``,
and one without it is taken to have 3c12770's). Both versions are
built with the port's nvcc flags into libraries of their own and called
on the same inputs, at every case of ``chip_smoke.py``'s phase 2 for
those kernels (``robust_gossip``: every table of ``ROBUST_CASES`` and
mode of ``ROBUST_MODES``, each on the instance each version dispatches
to; ``quantize_block`` and ``dequantize_block``: ``CODEC_CASES``, and
``dequantize_block`` also on one element, the launch floor), and for
``flash_attention`` also at Sk = 16, 32, 48, 64 and 65 for each head
width; a flash case whose keys fit the short kernel (64) is timed with
each instance forced, so the dispatch limits
(``ops.FLASH_SHORT_MAX_KEYS``) can be set where the two cross.
Each version's output is held to the plain version (bit-equal for
``gossip_mix``, ``robust_gossip`` and the codec kernels, 2e-5 for
``flash_attention``), then each case is timed base, this checkout, this
checkout, base (``chip_smoke.time_ms``: CUDA events around back-to-back
launches). One line per case, and all of them as JSON in ``FILE``
(default ``build/kernel_ab.json``). ``--kernels`` names the kernels to
time (default all five). Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# --kernels name -> its source in csrc/
SOURCES = {"mix": "gossip_mix.cu", "flash": "flash_attention.cu",
           "robust": "robust_gossip.cu", "quant": "quantize_block.cu",
           "dequant": "quantize_block.cu"}
# the keys the short kernel has room for (kShortMaxKeys in
# flash_attention.cu); the dispatch limits below it are ops'
SHORT_CAPACITY = 64
# Sk across the short kernel's room and one key past it, per head width
# (B, Hq, Hkv: the registry models' group shapes at a modest batch)
LIMIT_CASES = tuple(
    (f"sk{sk}-hd{hd}", b, sk, hq, hkv, hd, True, 0, None)
    for hd, b, hq, hkv in ((64, 256, 15, 5), (128, 64, 32, 16),
                           (192, 32, 24, 2))
    for sk in (16, 32, 48, SHORT_CAPACITY, SHORT_CAPACITY + 1))


def _both_instances(cases):
    """Each case as dispatched, or where the short kernel has room for its
    keys, twice: with each instance forced (the last field), so the two
    are timed on the same inputs and the dispatch limit can be set where
    they cross."""
    for c in cases:
        if c[2] <= SHORT_CAPACITY:
            for inst in ("short", "tile"):
                yield (f"{c[0]}-{inst}", *c[1:-1], inst)
        else:
            yield (*c[:-1], None)


def build(src_dir: Path, name: str, kernels: list[str]) -> ctypes.CDLL:
    """nvcc the sources of ``kernels`` in ``src_dir`` with the port's
    flags, link them into ``build/kernel_ab/<name>.so`` and load it."""
    work = REPO / "build" / "kernel_ab" / name
    work.mkdir(parents=True, exist_ok=True)
    nvcc = ops._nvcc()
    sources = sorted({SOURCES[k] for k in kernels})
    objs = [work / f"{Path(s).stem}.o" for s in sources]
    ops._run_all([[nvcc, *ops.NVCC_FLAGS, "-c", "-o", str(o),
                   str(src_dir / s)] for s, o in zip(sources, objs)])
    lib_path = work / f"{name}.so"
    ops._run_all([[nvcc, "-shared", "-o", str(lib_path), *map(str, objs)]])
    lib = ctypes.CDLL(str(lib_path))
    if "mix" in kernels:
        lib.gossip_mix_f32.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.gossip_mix_f32.restype = ctypes.c_int
    if "flash" in kernels:
        lib.flash_attention_f32.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_attention_f32.restype = ctypes.c_int
    if "robust" in kernels:
        # version 1 takes the register window d_pad after the table's D
        lib.robust_abi = _abi(lib, "robust_gossip")
        lib.robust_gossip_f32.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * (5 if lib.robust_abi == 1 else 4) + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.robust_gossip_f32.restype = ctypes.c_int
    if "quant" in kernels:
        # version 2 takes the cluster size after n_tiles
        lib.quant_abi = _abi(lib, "quantize_block")
        lib.quantize_block_f32.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * (5 if lib.quant_abi == 1 else 6) + \
            [ctypes.c_void_p]
        lib.quantize_block_f32.restype = ctypes.c_int
    if "dequant" in kernels:
        lib.dequantize_block_f32.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.dequantize_block_f32.restype = ctypes.c_int
    return lib


def _abi(lib: ctypes.CDLL, launcher: str) -> int:
    """The version of ``launcher``'s argument list: what the source's
    ``<launcher>_abi()`` returns, 1 for a source without it (the
    launchers of 3c12770)."""
    try:
        fn = getattr(lib, f"{launcher}_abi")
    except AttributeError:
        return 1
    fn.restype = ctypes.c_int
    return fn()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with CUDA error {err}")


def mix_call(lib, x, u, w):
    y = torch.empty_like(x)
    b, length = x.shape

    def call():
        _check(lib.gossip_mix_f32(x.data_ptr(), u.data_ptr(), w.data_ptr(),
                                  y.data_ptr(), b, u.shape[0], length,
                                  _stream()), "gossip_mix")
        return y
    return call


def flash_call(lib, q, k, v, causal: bool, window: int,
               instance: str | None = None):
    """One launch of ``lib``'s flash kernel: the instance ``ops`` would
    dispatch to, or ``instance``."""
    o = torch.empty_like(q)
    b, s, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    short = (instance or ops.flash_instance(q, k, v)) == "short"

    def call():
        _check(lib.flash_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
            sk, hq, hkv, hd, int(causal), window, int(short), hd ** -0.5,
            _stream()), "flash_attention")
        return o
    return call


def robust_call(lib, x, t, nbr, deg, b: float, mode: str):
    """One launch of ``lib``'s robust_gossip on the instance ``lib``
    dispatches a table of this width to."""
    y = torch.empty_like(x)
    d = nbr.shape[1]
    # version 1: the register window, 0 for its one instance past 64
    code = (((1 << max(d - 1, 0).bit_length())
             if d <= ops.ROBUST_REGISTER_MAX_DEGREE else 0),) \
        if lib.robust_abi == 1 else ()

    def call():
        _check(lib.robust_gossip_f32(
            x.data_ptr(), t.data_ptr(), nbr.data_ptr(), deg.data_ptr(),
            y.data_ptr(), x.shape[0], x.shape[1], d, *code,
            int(mode == "median"), float(b), int(b) if b >= 1.0 else -1,
            _stream()), "robust_gossip")
        return y
    return call


def quant_call(lib, x):
    w, p = x.shape
    row_len, tile_len, n_tiles = ref.wire_tiles(p)
    q = torch.empty(w, row_len, dtype=torch.int8, device=x.device)
    scales = torch.empty(w, n_tiles, device=x.device)
    cluster = ((ops.quantize_cluster(w, n_tiles, tile_len,
                                     ops.sm_count(x.device)),)
               if lib.quant_abi == 2 else ())

    def call():
        _check(lib.quantize_block_f32(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), w, p, row_len,
            tile_len, n_tiles, *cluster, _stream()), "quantize_block")
        return q, scales
    return call


def dequant_call(lib, q, scales, p: int, y):
    """One launch of ``lib``'s dequantize into ``y`` (both versions write
    the same tensor: at these sizes where a buffer lies moves a launch by
    as much as the versions differ)."""
    w, row_len = q.shape
    _, tile_len, n_tiles = ref.wire_tiles(p)

    def call():
        _check(lib.dequantize_block_f32(
            q.data_ptr(), scales.data_ptr(), y.data_ptr(), w, p, row_len,
            tile_len, n_tiles, _stream()), "dequantize_block")
        return y
    return call


def in_turns(calls: dict, cycles_per_ms: float, **kw) -> dict:
    """base, new, new, base: each version's two times."""
    times = {"base": [], "new": []}
    for which in ("base", "new", "new", "base"):
        times[which].append(cs.time_ms(calls[which], cycles_per_ms, **kw))
    return times


def _summary(kernel: str, case: str, times: dict, bound_ms: float,
             **extra) -> dict:
    base = sum(times["base"]) / 2
    new = sum(times["new"]) / 2
    spread = max(abs(a - b) / ((a + b) / 2)
                 for a, b in (times["base"], times["new"]))
    row = dict(kernel=kernel, case=case, base_ms=times["base"],
               new_ms=times["new"], speedup=base / new, spread=spread,
               bound_ms=bound_ms, new_share_of_bound=bound_ms / new,
               base_share_of_bound=bound_ms / base, **extra)
    cs.log("ab", **{k: (f"{v:.6f}" if isinstance(v, float) else v)
                    for k, v in row.items()})
    return row


def run_mix(libs: dict, cycles_per_ms: float) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, b, k, length, fleet in cs.MIX_CASES:
        x, u, w, _ = cs._mix_inputs(gen, b, k, length, fleet)
        want = ref.gossip_mix_ref(x, u, w)
        calls = {which: mix_call(lib, x, u, w) for which, lib in libs.items()}
        for which, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"gossip_mix[{name}] of {which} differs "
                                     "from its plain version")
        reps = 10 if name == "registry" else 50
        times = in_turns(calls, cycles_per_ms, batch=10, reps=reps)
        u_bytes = 0 if u.data_ptr() == x.data_ptr() else k * length
        bound_ms, _ = cs._bound((2 * b * length + u_bytes + b * k) * 4,
                                3 * b * k * length)
        rows.append(_summary("gossip_mix", name, times, bound_ms, B=b, K=k,
                             L=length))
        del x, u, w, want, calls
        torch.cuda.empty_cache()
    return rows


def run_flash(libs: dict, cycles_per_ms: float) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for case, b, s, hq, hkv, hd, causal, window, inst in _both_instances(
            (*cs.FLASH_CASES, *LIMIT_CASES)):
        q = torch.randn(b, s, hq, hd, generator=gen, device="cuda")
        k = torch.randn(b, s, hkv, hd, generator=gen, device="cuda")
        v = torch.randn(b, s, hkv, hd, generator=gen, device="cuda")
        # the wrapper's mask rule: causal forced where Sk % 128 != 0
        forced = causal or s % 128 != 0
        want = ref.flash_attention_ref(q, k, v, causal=forced, window=window)
        calls = {which: flash_call(lib, q, k, v, forced, window, inst)
                 for which, lib in libs.items()}
        for which, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            if bool(((got - want).abs() > cs.FLASH_ATOL
                     + cs.FLASH_RTOL * want.abs()).any()):
                raise AssertionError(f"flash_attention[{case}] of {which} "
                                     "differs from its plain version")
        heavy = s >= 1000
        times = in_turns(calls, cycles_per_ms, batch=2 if heavy else 5,
                         reps=10 if heavy else 30)
        mask = ref.attention_mask(s, s, causal=forced, window=window,
                                  device="cuda")
        bound_ms, _ = cs._bound((2 * b * s * hq * hd + 2 * b * s * hkv * hd)
                                * 4, 4 * b * hq * hd * int(mask.sum()))
        rows.append(_summary("flash_attention", case, times, bound_ms, B=b,
                             S=s, Hq=hq, Hkv=hkv, hd=hd,
                             instance=inst or ops.flash_instance(q, k, v)))
        del q, k, v, want, calls, mask
        torch.cuda.empty_cache()
    return rows


def run_robust(libs: dict, cycles_per_ms: float) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for case, w, spec, cut, zeroed, p, width in cs.ROBUST_CASES:
        nbr, deg, kind, exchanges = cs.robust_table(w, spec, cut, zeroed,
                                                    width)
        x = torch.randn(w, p, generator=gen, device="cuda")
        t = cs._lying(x)
        bound_ms, _, _ = cs.robust_bound(w, p, nbr.shape[1], exchanges)
        for mode, b in cs.ROBUST_MODES:
            name = f"{case}-{mode}:{b:g}"
            want = ref.robust_gossip_ref(x, t, nbr, deg, b=b, mode=mode)
            calls = {which: robust_call(lib, x, t, nbr, deg, b, mode)
                     for which, lib in libs.items()}
            for which, call in calls.items():
                got = call()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"robust_gossip[{name}] of {which} "
                                         "differs from its plain version")
            times = in_turns(calls, cycles_per_ms, batch=10,
                             reps=50 if kind == "register" else 10)
            rows.append(_summary("robust_gossip", name, times, bound_ms, W=w,
                                 P=p, D=nbr.shape[1], instance=kind))
            del want, calls
        del x, t
        torch.cuda.empty_cache()
    return rows


def run_quant(libs: dict, cycles_per_ms: float) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for case, w, p in cs.CODEC_CASES:
        x = 0.3 * torch.randn(w, p, generator=gen, device="cuda")
        want = ref.quantize_block_ref(x)
        calls = {which: quant_call(lib, x) for which, lib in libs.items()}
        for which, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            if not all(torch.equal(g, r) for g, r in zip(got, want)):
                raise AssertionError(f"quantize_block[{case}] of {which} "
                                     "differs from its plain version")
        row_len, tile_len, n_tiles = ref.wire_tiles(p)
        times = in_turns(calls, cycles_per_ms, batch=10)
        bound_ms, _ = cs._bound(4 * w * p + w * row_len + 4 * w * n_tiles,
                                6 * w * p)
        rows.append(_summary(
            "quantize_block", case, times, bound_ms, W=w, P=p,
            cluster=ops.quantize_cluster(w, n_tiles, tile_len,
                                         ops.sm_count(x.device))))
    return rows


def run_dequant(libs: dict, cycles_per_ms: float) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for case, w, p in (*cs.CODEC_CASES, ("floor", 1, 1)):
        x = 0.3 * torch.randn(w, p, generator=gen, device="cuda")
        q, scales = ref.quantize_block_ref(x)
        want = ref.dequantize_block_ref(q, scales, p)
        y = torch.empty_like(want)
        calls = {which: dequant_call(lib, q, scales, p, y)
                 for which, lib in libs.items()}
        for which, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"dequantize_block[{case}] of {which} "
                                     "differs from its plain version")
        times = in_turns(calls, cycles_per_ms, batch=10)
        n_tiles = scales.shape[1]
        bound_ms, _ = cs._bound(w * p + 4 * w * n_tiles + 4 * w * p, w * p)
        rows.append(_summary("dequantize_block", case, times, bound_ms, W=w,
                             P=p))
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--base", type=Path, required=True)
    parser.add_argument("--out", type=Path,
                        default=REPO / "build" / "kernel_ab.json")
    parser.add_argument("--kernels", nargs="+", choices=tuple(SOURCES),
                        default=list(SOURCES))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log("ab", card=repr(card))
    libs = {"base": build(args.base.resolve(), "base", args.kernels),
            "new": build(ops.CSRC, "new", args.kernels)}
    cycles_per_ms = cs._sleep_cycles_per_ms()
    runs = {"mix": run_mix, "flash": run_flash, "robust": run_robust,
            "quant": run_quant, "dequant": run_dequant}
    rows = []
    for kernel in args.kernels:
        rows += runs[kernel](libs, cycles_per_ms)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "cases": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
