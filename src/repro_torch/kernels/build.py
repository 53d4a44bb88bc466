"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The library's
file name carries a hash of its source and flags, so an edited source
builds anew and an unchanged one is reused. Builds run under a file lock,
so the worker processes of one job never compile at once, and all sources
start compiling together.

``count`` is called by a wrapper where it launches its kernel, and nowhere
else. It adds one to ``LAUNCHES``, the process's count per kernel, and one
to the calling thread's own count (``thread_launches``): a worker process
of the multi-job fleet runs one thread a job, and each job reports only
the launches its own thread made.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("significance", "wire_pack", "fused_adam", "flash_attention",
           "slstm_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()
_THREAD = threading.local()
_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)  # a host scalar block
# C signatures: every pointer and the stream as c_void_p, never a bare int
_ARGTYPES = {
    "significance_filter_launch": [_P, _P, _P, _P, _P, _I64, _I, _I, _F, _F,
                                   _P],
    "wire_nnz_launch": [_P, _I, _I64, _P, _P],
    # ... the look-back buffer, the call's sequence number, the stream
    "wire_pack_launch": [_P, _I, _I, _I64, _P, _P, _P, _P, _P, _P, _P, _U,
                         _P],
    "wire_unpack_add_launch": [_P, _I, _P, _I64, _P, _I64, _I, _P, _I, _P, _U,
                               _P],
    "adam_sig_update_launch": [_P] * 10 + [_I64, _I, _I, _I, _FP, _F, _P],
    "adam_update_launch": [_P] * 7 + [_I64, _I, _I, _FP, _P],
    "flash_attention_launch": [_P, _P, _P, _P] + [_I] * 10 + [_F, _P],
    # ... batch, steps, d, heads, r_bf16, then the plan: route, cluster,
    # units, rows, kslices, smem
    "slstm_scan_launch": [_P] * 9 + [_I] * 11 + [_P],
    "slstm_scan_max_clusters": [_I] * 9 + [ctypes.POINTER(ctypes.c_int)],
}


def thread_launches() -> collections.Counter:
    """The launches the calling thread made, per kernel."""
    counts = getattr(_THREAD, "launches", None)
    if counts is None:
        counts = _THREAD.launches = collections.Counter()
    return counts


def count(name: str) -> None:
    """One launch of kernel ``name``, in the process's and the calling
    thread's counts."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
    thread_launches()[name] += 1


def reset_launches() -> None:
    """Clear the process's counts and the calling thread's."""
    with _COUNT_LOCK:
        LAUNCHES.clear()
    thread_launches().clear()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that has no library yet, all at once;
    returns the library paths. ``nvcc``'s ptxas report is kept beside each
    library as ``<lib>.ptxas.txt``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: lib_path(n) for n in names}
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n, p in paths.items() if not p.exists()]
        procs = []
        for n in todo:
            tmp = paths[n].with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for n, tmp, proc in procs:
            out = proc.communicate()[0].decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"{n}.cu:\n{out}")
                continue
            Path(str(paths[n]) + ".ptxas.txt").write_text(out)
            os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def ptxas_summary(name: str) -> dict:
    """Registers and spill stores per kernel from the kept ptxas report."""
    text = Path(str(lib_path(name)) + ".ptxas.txt").read_text()
    regs = re.findall(r"Used (\d+) registers", text)
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
    return {"registers": [int(r) for r in regs],
            "spill_store_bytes": sum(spills)}


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        for fn, argtypes in _ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the kernels take it: the
    raw handle, read without building a ``torch.cuda.Stream`` object, which
    costs about as much host time as the launch itself."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check(code: int, kernel: str) -> None:
    """Raise on a launch the C side reported as failed."""
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {code}")


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
