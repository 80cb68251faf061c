"""Tree leaf <-> bytes with a tiny self-describing header, in the JAX
package's format (``repro/checkpoint/serialization.py``), so either
package restores what the other wrote.

Format: ``REPR0 | dtype-str-len | dtype-str | ndim | dims... | raw``;
optional zstd compression (magic flips to ``REPRZ``).  bfloat16 is stored
as its ``uint16`` bit pattern under the name ``"bfloat16"``.  Leaves are
named by their path as ``jax.tree_util.keystr`` writes it: ``['key']`` for
a dict entry (keys in sorted order, as JAX flattens them), ``.name`` for a
NamedTuple field, ``[i]`` for a list or tuple item; ``None`` holds no
leaf.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

try:
    import zstandard as _zstd

    _ZC = _zstd.ZstdCompressor(level=3)
    _ZD = _zstd.ZstdDecompressor()
except Exception:  # pragma: no cover
    _zstd = None

_MAGIC_RAW = b"REPR0"
_MAGIC_ZST = b"REPRZ"


def _np_view(x: Any) -> Tuple[np.ndarray, str]:
    """numpy view on the host + logical dtype string (bfloat16 as its
    uint16 bits)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def leaf_to_bytes(x: Any, compress: bool = False) -> bytes:
    arr, dt = _np_view(x)
    raw = np.ascontiguousarray(arr).tobytes()
    if compress and _zstd is not None:
        raw = _ZC.compress(raw)
        magic = _MAGIC_ZST
    else:
        magic = _MAGIC_RAW
    dtb = dt.encode()
    head = magic + struct.pack("<H", len(dtb)) + dtb
    head += struct.pack("<H", arr.ndim)
    head += struct.pack(f"<{arr.ndim}q", *arr.shape)
    return head + raw


def leaf_from_bytes(data: bytes) -> torch.Tensor:
    """One leaf as a CPU tensor of its stored dtype."""
    magic, off = data[:5], 5
    (dtl,) = struct.unpack_from("<H", data, off)
    off += 2
    dt = data[off:off + dtl].decode()
    off += dtl
    (ndim,) = struct.unpack_from("<H", data, off)
    off += 2
    shape = struct.unpack_from(f"<{ndim}q", data, off)
    off += 8 * ndim
    raw = data[off:]
    if magic == _MAGIC_ZST:
        if _zstd is None:  # pragma: no cover
            raise RuntimeError("zstd-compressed checkpoint, zstd missing")
        raw = _ZD.decompress(raw)
    elif magic != _MAGIC_RAW:
        raise ValueError("bad leaf header")
    if dt == "bfloat16":
        bits = np.frombuffer(raw, np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, dt).reshape(shape).copy())


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [pair for f in tree._fields
                for pair in flatten_with_path(getattr(tree, f),
                                              f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, x in enumerate(tree)
                for pair in flatten_with_path(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                  prefix: str = "") -> Any:
    """A tree shaped like ``tree`` with each leaf ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, f),
                                          f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, x, f"{prefix}[{i}]")
                          for i, x in enumerate(tree))
    return fn(prefix, tree)


def tree_paths(tree: Any) -> List[str]:
    return [p for p, _ in flatten_with_path(tree)]
