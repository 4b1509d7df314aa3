"""The port's hand-written CUDA kernels: build, bind and launch.

Build (at first use): ``nvcc`` compiles every source in ``csrc/`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
``build/repro_torch_kernels/`` under the checkout, named by a hash of the
sources and flags so an edited source is never served a stale library.
The library is bound with ``ctypes`` (pointers and the stream as
``c_void_p``). Nothing CUDA-specific runs at import, so the package
imports and its tests run on machines without ``nvcc`` or a GPU.

Dispatch is by the device of the tensors the caller passed: CPU tensors
go to the plain PyTorch version in ``ref.py``; CUDA tensors go to the
kernel, or the call raises. There is no fallback from a failed build or
launch to the plain version. ``LAUNCHES`` counts successful launches per
kernel, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.ref import gossip_mix_ref

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"gossip_mix": 0}

# gossip_mix stages one row of weights in static shared memory (48 KB)
# and puts the B output rows on the grid's y axis
_MAX_NEIGHBORS = 48 * 1024 // 4
_MAX_ROWS = 65535

_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
        "kernels cannot be built on this machine")


def build() -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` into the shared library unless a library of
    these exact sources and flags exists; returns (path, nvcc's output —
    empty when nothing was compiled). Raises with nvcc's output if the
    build fails."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"librepro_torch_kernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return out, log


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        lib.gossip_mix_f32.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.gossip_mix_f32.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_cuda(name: str, tensors: dict[str, torch.Tensor]) -> None:
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: all operands must be on one CUDA device "
                         "(or all on the CPU), got "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    for k, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def gossip_mix(x: torch.Tensor, u: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Eq. 5 mix y[b] = x[b] + sum_k w[b, k] (u[k] - x[b]).

    x: [B, L], u: [K, L], w: [B, K], f32 -> [B, L]. CPU tensors run the
    plain version (``ref.gossip_mix_ref``); CUDA tensors launch the
    kernel on the current stream and count the launch."""
    if x.dim() != 2 or u.dim() != 2 or w.dim() != 2:
        raise ValueError("gossip_mix takes x [B, L], u [K, L], w [B, K]")
    (b, length), k = x.shape, u.shape[0]
    if u.shape[1] != length or tuple(w.shape) != (b, k):
        raise ValueError(f"gossip_mix shapes disagree: x {tuple(x.shape)}, "
                         f"u {tuple(u.shape)}, w {tuple(w.shape)}")
    if all(t.device.type == "cpu" for t in (x, u, w)):
        return gossip_mix_ref(x, u, w)
    _check_cuda("gossip_mix", {"x": x, "u": u, "w": w})
    if b > _MAX_ROWS or k > _MAX_NEIGHBORS or length >= 2 ** 31:
        raise ValueError(f"gossip_mix supports B <= {_MAX_ROWS}, "
                         f"K <= {_MAX_NEIGHBORS}, L < 2**31; got "
                         f"B={b}, K={k}, L={length}")
    y = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gossip_mix_f32(x.data_ptr(), u.data_ptr(), w.data_ptr(),
                                 y.data_ptr(), b, k, length, stream)
    if err != 0:
        raise RuntimeError("gossip_mix launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    LAUNCHES["gossip_mix"] += 1
    return y
