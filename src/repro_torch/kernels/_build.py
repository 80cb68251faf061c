"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every kernel source is one ``csrc/*.cu`` file beside its ``ops.py``, with a
plain C entry point (no PyTorch headers), compiled for ``sm_90a`` into its
own shared library under ``build/repro_torch_kernels/`` at the repository
root.  The library name carries a hash of the sources and flags, so an edit
rebuilds and a stale library is never loaded.  :func:`build_all` starts one
``nvcc`` per source at once; :func:`library` builds on first use.

Wrappers pass tensors as ``data_ptr()`` integers and the stream as
``torch.cuda.current_stream().cuda_stream``; each C entry point returns
``cudaGetLastError()`` of its launch and :func:`check` raises on a non-zero
code.  Nothing here runs at import time: the CPU tests import every module
of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
COMMON_INCLUDE = KERNELS_DIR / "csrc"

#: kernel name -> its source, relative to this directory
SOURCES: Dict[str, str] = {
    "paged_chunk_attention": "paged_attention/csrc/paged_chunk_attention.cu",
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-I{COMMON_INCLUDE}"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C signature of each entry point (every one returns a cudaError_t as int)
ARGTYPES: Dict[str, List[type]] = {
    # q, k_new, v_new, k_pages, v_pages, block_tables, lengths, page_map,
    # k_scales, v_scales, out, part_m, part_l, part_acc, b, t, kv, g, hd,
    # page, max_pages, n_split, bf16, quant, scale, stream
    "paged_chunk_attention": [_P] * 14 + [_I] * 10 + [_F, _P],
    # q, k, v, out, b, s, h, kv, hd, bf16, scale, stream
    "flash_attention": [_P] * 4 + [_I] * 6 + [_F, _P],
}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas resource report of each kernel built by this process
BUILD_LOGS: Dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [KERNELS_DIR / SOURCES[name],
                 *sorted(COMMON_INCLUDE.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:12]}.so"


def build_all(names: Optional[List[str]] = None) -> float:
    """Compile every missing kernel library in parallel; returns seconds."""
    names = list(SOURCES) if names is None else names
    todo: List[Tuple[str, Path]] = [(n, _target(n)) for n in names
                                    if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(KERNELS_DIR / SOURCES[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        fn = getattr(lib, name)
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check_aligned(name: str, **tensors) -> None:
    """The kernels stage tiles with 16-byte loads."""
    for arg, x in tensors.items():
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
