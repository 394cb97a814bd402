"""Build, load and launch the port's hand-written CUDA kernels.

The counterpart of the reference's ``kernels/runtime.py``. Each
``csrc/<name>.cu`` is compiled at first use by its own ``nvcc`` (all started
together) into ``build/repro_torch/<name>-<hash>.so`` at the root of the
checkout, keyed by the hash of the source and the shared headers
(``csrc/*.cuh``) so an edit rebuilds, and loaded
as a plain-C library through ``ctypes``: pointers and the stream are passed
as ``c_void_p``. Every C entry point returns ``cudaGetLastError()``;
``check`` raises when it is not 0.

Dispatch rule for every kernel wrapper (kernels/*.py): a CPU tensor takes
the kernel's plain PyTorch version, a CUDA tensor launches the kernel or
raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fused_sparse_ffn", "paged_attention", "sparse_matmul_tokens",
           "sparse_up_matmul", "fused_up_relu", "sparse_matmul",
           "expert_up_matmul", "expert_down_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch are built at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> float:
    """Compile every missing library in ``names``, one nvcc per source, all
    started together. Returns the wall seconds spent; raises with the
    compiler's output when a build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"--- nvcc {name}.cu (rc {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all kernels on
    first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def entry(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point with its argtypes declared (restype int)."""
    f = getattr(library(name), fn)
    if f.argtypes is None:
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return f


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library(name).repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {rc} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    """True when every given tensor lies on the CPU, or every one on
    "meta" (the dry run's shapes: take the plain version); False when all
    are CUDA tensors of one device (launch). Anything else raises: a CUDA
    call never falls back."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs) or all(d.type == "meta"
                                                 for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"kernel inputs must all lie on one CUDA device or "
                         f"all on the CPU; got {sorted(map(str, devs))}")
    return False


# csrc/common.cuh launch_tile_gather_rows: its block shape, and the grid
# size it aims for (several waves over the H100's 132 SMs)
GATHER_ROWS, GATHER_COLS, GATHER_TARGET_BLOCKS = 16, 64, 1024


def gather_runs(T: int, K: int, D: int, device) -> tuple:
    """(run, scratch) for the tile gather of common.cuh: the K list slots
    are cut into S = ceil(K / run) runs, as many as fill the grid to about
    GATHER_TARGET_BLOCKS blocks; scratch is the (T, S, D) f32 run-sum
    buffer, or None when S == 1. Its size is bounded (under 9 MB) whatever
    T and K are."""
    groups = -(-T // GATHER_ROWS) * -(-D // GATHER_COLS)
    S = max(1, min(K, -(-GATHER_TARGET_BLOCKS // groups)))
    run = max(1, -(-K // S))
    S = -(-K // run) if K else 1
    scratch = (torch.empty((T, S, D), dtype=torch.float32, device=device)
               if S > 1 else None)
    return run, scratch


# csrc/up_tiles.cuh: output columns per block (one weight tile)
UT_BN = 128

# csrc/tile_group.cuh: its chunk size, longest run and most runs, and the
# bound on its scratch
TG_M, TG_RMAX, TG_MAX_RUNS = 64, 128, 64
TG_SCRATCH_BYTES = 32 << 20


def tile_group_slab_rows(D: int, n_runs: int):
    """Rows per launch of the tile-grouped routine: with more than one run
    a slab's scratch, its pair partials (rows x n_runs x D f32) and runs
    mask (rows x 8 bytes), stays under TG_SCRATCH_BYTES. None with one run
    (no scratch: the blocks write y)."""
    if n_runs == 1:
        return None
    return max(1, TG_SCRATCH_BYTES // (n_runs * D * 4 + 8))


def require_aligned(**tensors: Optional[torch.Tensor]) -> None:
    """The TMA and 16-byte copies of the tensor-core routines need 16-byte
    aligned bases."""
    for k, t in tensors.items():
        if t is not None:
            require(t.data_ptr() % 16 == 0, lambda: f"{k} must be 16-byte aligned")


def require(cond: bool, msg) -> None:
    """Raise ValueError(msg) unless cond; msg may be a callable that builds
    the message, so a wrapper's hot path formats nothing."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


def dtype_code(*tensors: torch.Tensor) -> int:
    dts = {t.dtype for t in tensors}
    require(len(dts) == 1 and next(iter(dts)) in DTYPE_CODES,
            lambda: f"kernel takes one dtype of {list(DTYPE_CODES)}; got {dts}")
    return DTYPE_CODES[next(iter(dts))]


def require_contiguous(**tensors: Optional[torch.Tensor]) -> None:
    for k, t in tensors.items():
        if t is not None:
            require(t.is_contiguous(), lambda: f"{k} must be contiguous")
