"""The port's hand-written CUDA kernels: build, bind and launch.

Build (at first use): ``nvcc`` compiles every source in ``csrc/`` for
Hopper (``sm_90a``), one process per source started together, and links
them into one shared library with a plain C interface,
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

from repro_torch.kernels import ref

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

LAUNCHES = {"gossip_mix": 0, "quantize_block": 0, "dequantize_block": 0,
            "sparsify_block": 0, "gossip_edges": 0, "robust_gossip": 0}

# gossip_mix stages one row of weights in static shared memory (48 KB);
# every kernel puts its rows (B, or the W workers) on the grid's y axis
_MAX_NEIGHBORS = 48 * 1024 // 4
_MAX_ROWS = 65535
# robust_gossip's template instances: one per power of two up to this
# many neighbours (a window of D_PAD + 1 registers a thread)
ROBUST_MAX_DEGREE = 64

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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; return their joined output, or raise with
    the first failing command's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return "".join(outs)


def build() -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` into the shared library unless a library of
    these exact sources and flags exists: one ``nvcc -c`` per source, all
    started together, then one link. Returns (path, nvcc's output — empty
    when nothing was compiled). Raises with nvcc's output if the build
    fails."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"librepro_torch_kernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    nvcc = _nvcc()
    work = BUILD_DIR / f"{out.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    objs = [work / f"{src.stem}.o" for src in sources]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objs)])
    tmp = work / out.name
    log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, out)
    shutil.rmtree(work)
    return out, log


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        lib.gossip_mix_f32.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.quantize_block_f32.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.dequantize_block_f32.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.sparsify_block_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64] + \
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.gossip_edges_f32.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.robust_gossip_f32.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p]
        for fn in (lib.gossip_mix_f32, lib.quantize_block_f32,
                   lib.dequantize_block_f32, lib.sparsify_block_f32,
                   lib.gossip_edges_f32, lib.robust_gossip_f32):
            fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_cuda(name: str, tensors: dict[str, torch.Tensor],
                dtypes: dict[str, torch.dtype] | None = None) -> None:
    """Operands of a launch: one CUDA device, contiguous, float32 unless
    ``dtypes`` names another type."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: all operands must be on one CUDA device "
                         "(or all on the CPU), got "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    for k, t in tensors.items():
        want = (dtypes or {}).get(k, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name}: {k} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def _launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the library's launcher ``fn`` on ``device``'s current stream,
    raise on a refused launch, count a successful one."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{_library().cuda_error_string(err).decode()} "
                           f"({err})")
    LAUNCHES[name] += 1


def _check_rows(name: str, w: int, p: int) -> None:
    if w > _MAX_ROWS or p >= 2 ** 31:
        raise ValueError(f"{name} supports W <= {_MAX_ROWS} rows of "
                         f"P < 2**31; got W={w}, P={p}")


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
    if _on_cpu(x, u, w):
        return ref.gossip_mix_ref(x, u, w)
    _check_cuda("gossip_mix", {"x": x, "u": u, "w": w})
    if b > _MAX_ROWS or k > _MAX_NEIGHBORS or length >= 2 ** 31:
        raise ValueError(f"gossip_mix supports B <= {_MAX_ROWS}, "
                         f"K <= {_MAX_NEIGHBORS}, L < 2**31; got "
                         f"B={b}, K={k}, L={length}")
    y = torch.empty_like(x)
    _launch("gossip_mix", _library().gossip_mix_f32, x.device, x.data_ptr(),
            u.data_ptr(), w.data_ptr(), y.data_ptr(), b, k, length)
    return y


def quantize_block(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 codec's encode on a fleet's flat rows: x [W, P] f32 ->
    (q int8 [W, rows·cols], scales f32 [W, n_tiles]) in the tile layout
    of ``ref.wire_tiles``. CPU tensors run ``ref.quantize_block_ref``;
    CUDA tensors launch the kernel (one launch for all W rows)."""
    if x.dim() != 2:
        raise ValueError("quantize_block takes x [W, P]")
    if _on_cpu(x):
        return ref.quantize_block_ref(x)
    _check_cuda("quantize_block", {"x": x})
    w, p = x.shape
    _check_rows("quantize_block", w, p)
    row_len, tile_len, n_tiles = ref.wire_tiles(p)
    q = torch.empty(w, row_len, dtype=torch.int8, device=x.device)
    scales = torch.empty(w, n_tiles, dtype=torch.float32, device=x.device)
    _launch("quantize_block", _library().quantize_block_f32, x.device,
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), w, p, row_len,
            tile_len, n_tiles)
    return q, scales


def dequantize_block(q: torch.Tensor, scales: torch.Tensor,
                     num_params: int) -> torch.Tensor:
    """The int8 codec's decode: q int8 [W, rows·cols] and scales f32
    [W, n_tiles] (``quantize_block``'s outputs) -> y f32 [W, P] with
    y = q · scale. CPU tensors run ``ref.dequantize_block_ref``; CUDA
    tensors launch the kernel."""
    row_len, tile_len, n_tiles = ref.wire_tiles(num_params)
    if q.dim() != 2 or tuple(q.shape[1:]) != (row_len,) or \
            tuple(scales.shape) != (q.shape[0], n_tiles):
        raise ValueError(f"dequantize_block at P={num_params} takes q "
                         f"[W, {row_len}] and scales [W, {n_tiles}], got "
                         f"{tuple(q.shape)} and {tuple(scales.shape)}")
    if _on_cpu(q, scales):
        return ref.dequantize_block_ref(q, scales, num_params)
    _check_cuda("dequantize_block", {"q": q, "scales": scales},
                {"q": torch.int8})
    w = q.shape[0]
    _check_rows("dequantize_block", w, num_params)
    y = torch.empty(w, num_params, dtype=torch.float32, device=q.device)
    _launch("dequantize_block", _library().dequantize_block_f32, q.device,
            q.data_ptr(), scales.data_ptr(), y.data_ptr(), w, num_params,
            row_len, tile_len, n_tiles)
    return y


def sparsify_block(x: torch.Tensor, gate: torch.Tensor,
                   thresh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The sparse codecs' mask-and-pack: x [W, P], gate [W, P] or one
    shared row [1, P], thresh [W], all f32 -> (y [W, P] keeping x where
    gate >= thresh of its row, nnz int32 [W, n_tiles] survivors per
    tile). CPU tensors run ``ref.sparsify_block_ref``; CUDA tensors
    launch the kernel."""
    if x.dim() != 2 or gate.dim() != 2 or \
            gate.shape[0] not in (1, x.shape[0]) or \
            gate.shape[1] != x.shape[1] or \
            tuple(thresh.shape) != (x.shape[0],):
        raise ValueError("sparsify_block takes x [W, P], gate [W, P] or "
                         f"[1, P], thresh [W]; got {tuple(x.shape)}, "
                         f"{tuple(gate.shape)}, {tuple(thresh.shape)}")
    if _on_cpu(x, gate, thresh):
        return ref.sparsify_block_ref(x, gate, thresh)
    _check_cuda("sparsify_block", {"x": x, "gate": gate, "thresh": thresh})
    w, p = x.shape
    _check_rows("sparsify_block", w, p)
    _, tile_len, n_tiles = ref.wire_tiles(p)
    y = torch.empty_like(x)
    nnz = torch.empty(w, n_tiles, dtype=torch.int32, device=x.device)
    gate_stride = p if gate.shape[0] > 1 else 0
    _launch("sparsify_block", _library().sparsify_block_f32, x.device,
            x.data_ptr(), gate.data_ptr(), gate_stride, thresh.data_ptr(),
            y.data_ptr(), nnz.data_ptr(), w, p, tile_len, n_tiles)
    return y, nnz


def gossip_edges(x: torch.Tensor, t: torch.Tensor, row_ptr: torch.Tensor,
                 col: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sparse Eq. 5 over a CSR edge list sorted by destination: y[d] =
    x[d] + sum_e w_e (t[col_e] - x[d]), row d's edges in list order.

    x, t: [W, P] f32 (t = x for honest gossip, the transmitted copy for
    a lying wire); row_ptr [W + 1], col [E] int32; w [E] f32
    (``core/topology.edges_to_csr``). CPU tensors run the plain version
    (``ref.gossip_edges_ref``); CUDA tensors launch the kernel."""
    if x.dim() != 2 or t.shape != x.shape or row_ptr.dim() != 1 or \
            row_ptr.shape[0] != x.shape[0] + 1 or col.dim() != 1 or \
            w.shape != col.shape:
        raise ValueError("gossip_edges takes x, t [W, P], row_ptr [W + 1], "
                         f"col [E], w [E]; got {tuple(x.shape)}, "
                         f"{tuple(t.shape)}, {tuple(row_ptr.shape)}, "
                         f"{tuple(col.shape)}, {tuple(w.shape)}")
    if _on_cpu(x, t, row_ptr, col, w):
        return ref.gossip_edges_ref(x, t, row_ptr, col, w)
    _check_cuda("gossip_edges", {"x": x, "t": t, "row_ptr": row_ptr,
                                 "col": col, "w": w},
                {"row_ptr": torch.int32, "col": torch.int32})
    n, p = x.shape
    _check_rows("gossip_edges", n, p)
    y = torch.empty_like(x)
    _launch("gossip_edges", _library().gossip_edges_f32, x.device,
            x.data_ptr(), t.data_ptr(), row_ptr.data_ptr(), col.data_ptr(),
            w.data_ptr(), y.data_ptr(), n, p)
    return y


def robust_gossip(x: torch.Tensor, t: torch.Tensor, nbr: torch.Tensor,
                  deg: torch.Tensor, *, b: float, mode: str) -> torch.Tensor:
    """Coordinate-wise robust aggregation of each worker's closed
    neighbourhood: its own row x[i] and the transmitted rows
    t[nbr[i, :deg[i]]], trimmed mean (``mode="trimmed"``, trim knob
    ``b``: a fraction of the neighbourhood when < 1, else a count) or
    median (``mode="median"``); deg 0 keeps x[i].

    x, t: [W, P] f32; nbr: [W, D] int32 padded table, D <=
    ``ROBUST_MAX_DEGREE``; deg: [W] int32. CPU tensors run the plain
    version (``ref.robust_gossip_ref``); CUDA tensors launch the kernel
    instance for D rounded up to a power of two, and raise above the
    largest instance."""
    if mode not in ("trimmed", "median"):
        raise ValueError(f"unknown robust mode {mode!r}")
    if x.dim() != 2 or t.shape != x.shape or nbr.dim() != 2 or \
            nbr.shape[0] != x.shape[0] or tuple(deg.shape) != (x.shape[0],):
        raise ValueError("robust_gossip takes x, t [W, P], nbr [W, D], "
                         f"deg [W]; got {tuple(x.shape)}, {tuple(t.shape)}, "
                         f"{tuple(nbr.shape)}, {tuple(deg.shape)}")
    d = nbr.shape[1]
    if d > ROBUST_MAX_DEGREE:
        raise ValueError(f"robust_gossip supports neighbour tables of D <= "
                         f"{ROBUST_MAX_DEGREE} (its largest kernel "
                         f"instance); got D={d}")
    if _on_cpu(x, t, nbr, deg):
        return ref.robust_gossip_ref(x, t, nbr, deg, b=b, mode=mode)
    _check_cuda("robust_gossip", {"x": x, "t": t, "nbr": nbr, "deg": deg},
                {"nbr": torch.int32, "deg": torch.int32})
    n, p = x.shape
    _check_rows("robust_gossip", n, p)
    d_pad = 1 << max(d - 1, 0).bit_length()
    y = torch.empty_like(x)
    _launch("robust_gossip", _library().robust_gossip_f32, x.device,
            x.data_ptr(), t.data_ptr(), nbr.data_ptr(), deg.data_ptr(),
            y.data_ptr(), n, p, d, d_pad, int(mode == "median"), float(b),
            int(b) if b >= 1.0 else -1)
    return y
