"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every kernel source is one ``csrc/*.cu`` file beside its ``ops.py``, with
plain C entry points (no PyTorch headers), compiled for ``sm_90a`` into its
own shared library under ``build/repro_torch_kernels/`` at the repository
root.  The library name carries a hash of the sources and flags, so an edit
rebuilds and a stale library is never loaded.  :func:`build_all` starts one
``nvcc`` per source at once; :func:`library` builds on first use and
:func:`entry` returns one entry point of a library.

Wrappers pass tensors as ``data_ptr()`` integers and the stream as
``torch.cuda.current_stream().cuda_stream``; :func:`launch` calls an
entry point with the tensors' card current.  Each C entry point returns
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
    "ssd_scan": "ssd_scan/csrc/ssd_scan.cu",
}

#: entry point -> the library that exports it, where the names differ
ENTRY_LIBRARY: Dict[str, str] = {
    "paged_attention": "paged_chunk_attention",
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
    # q, k_pages, v_pages, block_tables, lengths, out, part_m, part_l,
    # part_acc, b, kv, g, hd, page, max_pages, n_split, bf16, scale, stream
    "paged_attention": [_P] * 9 + [_I] * 8 + [_F, _P],
    # q, k, v, out, b, s, h, kv, hd, bf16, scale, stream
    "flash_attention": [_P] * 4 + [_I] * 6 + [_F, _P],
    # x, dt, A, B, C, y, state, b, s, H, P, N, bf16, stream
    "ssd_scan": [_P] * 7 + [_I] * 6 + [_P],
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


def library_path(name: str) -> Path:
    """The library file one kernel source builds into (named by a hash of
    its sources and the flags)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [KERNELS_DIR / SOURCES[name],
                 *sorted(COMMON_INCLUDE.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:12]}.so"


def build_all(names: Optional[List[str]] = None) -> float:
    """Compile every missing kernel library in parallel; returns seconds."""
    names = list(SOURCES) if names is None else names
    todo: List[Tuple[str, Path]] = [(n, library_path(n)) for n in names
                                    if not library_path(n).exists()]
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
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name in ARGTYPES:
            if ENTRY_LIBRARY.get(fn_name, fn_name) == name:
                fn = getattr(lib, fn_name)
                fn.argtypes = ARGTYPES[fn_name]
                fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def entry(name: str):
    """The ctypes function of one entry point, its library built first if
    needed."""
    return getattr(library(ENTRY_LIBRARY.get(name, name)), name)


def check_tensors(name: str, device, expect: Dict[str, tuple]) -> None:
    """Raise unless every ``arg: (tensor, shape, dtype)`` of ``expect`` lies
    on ``device`` with that shape and dtype and is contiguous."""
    for arg, (x, shape, dtype) in expect.items():
        if x.device != device:
            raise ValueError(f"{name}: {arg} on {x.device}, expected {device}")
        if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {tuple(x.shape)} {x.dtype}, "
                             f"expected {tuple(shape)} {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def check_aligned(name: str, **tensors) -> None:
    """The kernels stage tiles with 16-byte loads."""
    for arg, x in tensors.items():
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def launch(name: str, device, *args) -> None:
    """Call entry point ``name`` with ``device`` the current card (the
    launch, and the function attributes the entry point sets, go to the
    card its tensors lie on) and raise on the error it returns."""
    import torch

    fn = entry(name)
    with torch.cuda.device(device):
        rc = fn(*args)
    check(name, rc)
