#!/usr/bin/env python3
"""Time the port's ``gossip_mix`` and ``flash_attention`` kernels against
another version of their CUDA sources, on one card, in turns.

    python3 tools/kernel_ab.py --base DIR [--out FILE] [--kernels flash]

``DIR`` holds the other version's ``gossip_mix.cu`` and
``flash_attention.cu`` (for example written there from a git revision
with ``git show REV:src/repro_torch/kernels/csrc/gossip_mix.cu``). Both
versions are built with the port's nvcc flags into libraries of their
own and called on the same inputs, at every ``gossip_mix`` and
``flash_attention`` case of ``chip_smoke.py``'s phase 2 and at Sk =
16, 32, 48, 64 and 65 for each head width; a flash case whose keys fit
the short kernel (64) is timed with each instance forced, so the
dispatch limits (``ops.FLASH_SHORT_MAX_KEYS``) can be set where the two
cross.
Each version's output is held to the plain version (bit-equal for
``gossip_mix``, 2e-5 for ``flash_attention``), then each case is timed
base, this checkout, this checkout, base (``chip_smoke.time_ms``: CUDA
events around back-to-back launches). One line per case, and all of
them as JSON in ``FILE`` (default ``build/kernel_ab.json``).
``--kernels`` limits the run to ``mix`` or ``flash`` (default both).
Needs a CUDA device and ``nvcc``.
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

SOURCES = ("gossip_mix.cu", "flash_attention.cu")
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


def build(src_dir: Path, name: str) -> ctypes.CDLL:
    """nvcc each of SOURCES in ``src_dir`` with the port's flags, link
    them into ``build/kernel_ab/<name>.so`` and load it."""
    work = REPO / "build" / "kernel_ab" / name
    work.mkdir(parents=True, exist_ok=True)
    nvcc = ops._nvcc()
    objs = [work / f"{Path(s).stem}.o" for s in SOURCES]
    ops._run_all([[nvcc, *ops.NVCC_FLAGS, "-c", "-o", str(o),
                   str(src_dir / s)] for s, o in zip(SOURCES, objs)])
    lib_path = work / f"{name}.so"
    ops._run_all([[nvcc, "-shared", "-o", str(lib_path), *map(str, objs)]])
    lib = ctypes.CDLL(str(lib_path))
    lib.gossip_mix_f32.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    # the launcher takes the instance (short_path) where the source has
    # two instances, and not before
    two = "short_path" in (src_dir / "flash_attention.cu").read_text()
    lib.flash_attention_f32.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * (9 if two else 8) + [ctypes.c_float,
                                              ctypes.c_void_p]
    lib.flash_two_instances = two
    for fn in (lib.gossip_mix_f32, lib.flash_attention_f32):
        fn.restype = ctypes.c_int
    return lib


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
    inst = (int(short),) if lib.flash_two_instances else ()

    def call():
        _check(lib.flash_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
            sk, hq, hkv, hd, int(causal), window, *inst, hd ** -0.5,
            _stream()), "flash_attention")
        return o
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--base", type=Path, required=True)
    parser.add_argument("--out", type=Path,
                        default=REPO / "build" / "kernel_ab.json")
    parser.add_argument("--kernels", choices=("mix", "flash", "both"),
                        default="both")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log("ab", card=repr(card))
    libs = {"base": build(args.base.resolve(), "base"),
            "new": build(ops.CSRC, "new")}
    cycles_per_ms = cs._sleep_cycles_per_ms()
    rows = []
    if args.kernels in ("mix", "both"):
        rows += run_mix(libs, cycles_per_ms)
    if args.kernels in ("flash", "both"):
        rows += run_flash(libs, cycles_per_ms)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "cases": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
