"""A leaf stored as its blocks over a mesh, the port's counterpart of a
sharded ``jax.Array``.

A :class:`Blocked` holds one tensor per distinct block of its
:class:`~repro_torch.distributed.mesh.NamedSharding` (block-grid order,
:meth:`NamedSharding.blocks`), each on the device of the first mesh
position that holds it, and the whole leaf's shape.  A leaf its sharding
replicates whole (a norm's weight, the optimizer's step) has one block
and is stored as a plain tensor on the mesh's first device.  It is a
``torch.utils._pytree`` node whose children are the blocks, so whatever
maps over the leaves of a tree (the optimizers' per-leaf rules, the
schedules, ``zeros_f32``, ``tree_map``) runs block by block where each
block lies, and two trees laid out differently do not flatten alike.

Nothing here materialises a whole leaf unless asked to (:func:`whole`,
the checkpoint's host copy): a training forward takes each position's
part of a leaf at use (:func:`take`, a differentiable concatenation of the
pieces of the blocks it covers, copied onto the position's device), so
autograd returns each block's gradient on the block's own device.  A
:func:`take` whose part spans several blocks along a dim reports the
all-gather it stands for (the SPMD program gathers the part from the
positions along that dim's axes) to the active op counter
(:mod:`repro_torch.accounting`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch import accounting
from repro_torch.distributed.mesh import NamedSharding, Region, split_range


class Blocked:
    """A tensor of ``shape`` stored as ``blocks``, laid out by
    ``sharding`` (one tensor per distinct block, in block-grid order)."""

    __slots__ = ("blocks", "sharding", "shape")

    def __init__(self, blocks: Sequence[torch.Tensor],
                 sharding: NamedSharding, shape: Sequence[int]):
        self.blocks = tuple(blocks)
        self.sharding = sharding
        self.shape = torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def __repr__(self) -> str:
        return (f"Blocked({tuple(self.shape)}, {self.dtype}, "
                f"spec={self.sharding.spec}, {len(self.blocks)} blocks)")


def _flatten(x: Blocked) -> Tuple[List[torch.Tensor], Any]:
    return list(x.blocks), (x.sharding, tuple(x.shape))


pytree.register_pytree_node(
    Blocked, _flatten, lambda blocks, ctx: Blocked(blocks, *ctx),
    serialized_type_name="repro_torch.distributed.blocked.Blocked")


def is_blocked(x: Any) -> bool:
    return isinstance(x, Blocked)


def leaves(tree: Any) -> List[Any]:
    """The tree's leaves with each :class:`Blocked` one leaf."""
    return pytree.tree_leaves(tree, is_leaf=is_blocked)


def map_leaves(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over whole leaves (a :class:`Blocked` is one leaf; ``None``
    in ``rest``, a missing sharding, is passed as is)."""
    return pytree.tree_map(fn, tree, *rest,
                           is_leaf=lambda x: x is None or is_blocked(x))


# ---------------------------------------------------------------------------
# pieces of a leaf
# ---------------------------------------------------------------------------

def piece(x: Any, region: Region, device: torch.device) -> torch.Tensor:
    """The elements of ``x`` (a tensor or a :class:`Blocked`) in
    ``region`` on ``device``: each covered block narrowed to its part (a
    view), copied to ``device`` (nothing where it lies there) and the parts
    concatenated in order, dim by dim.  A region inside one block on
    ``device`` is a view of it.  Differentiable into the blocks."""
    if not is_blocked(x):
        for dim, (lo, n) in enumerate(region):
            if n != x.shape[dim]:
                x = x.narrow(dim, lo, n)
        return x if x.device == device else x.to(device)
    parts = x.sharding.parts(x.ndim)
    strides = [math.prod(parts[k + 1:]) for k in range(len(parts))]

    def rec(k: int, j: int, sub: Tuple[Tuple[int, int], ...]
            ) -> torch.Tensor:
        if k == x.ndim:
            return piece(x.blocks[j], sub, device)
        start, size = region[k]
        out = []
        for i in range(parts[k]):
            b0, bn = split_range(x.shape[k], parts[k], i)
            lo, hi = max(b0, start), min(b0 + bn, start + size)
            if lo < hi:
                out.append(rec(k + 1, j + i * strides[k],
                               sub + ((lo - b0, hi - lo),)))
        return out[0] if len(out) == 1 else torch.cat(out, dim=k)

    return rec(0, 0, ())


def take(x: Any, device: torch.device, dim: Optional[int] = None,
         ranges: Sequence[Tuple[int, int]] = ()) -> torch.Tensor:
    """``x`` on ``device``, whole, or its ``ranges`` along ``dim``
    concatenated in order (a position's part of a leaf at use)."""
    full = [(0, n) for n in x.shape]
    if dim is None:
        regions = [tuple(full)]
    else:
        regions = []
        for start, size in ranges:
            full[dim] = (start, size)
            regions.append(tuple(full))
    out = [piece(x, r, device) for r in regions]
    out = out[0] if len(out) == 1 else torch.cat(out, dim=dim)
    if accounting.active() and is_blocked(x):
        axes = spanned_axes(x, regions)
        if axes:
            accounting.collective("all-gather",
                                  out.numel() * out.element_size(), 1, axes)
    return out


def spanned_axes(x: Blocked, regions: Sequence[Region]) -> Tuple[str, ...]:
    """The mesh axes of the dims along which ``regions`` of ``x`` cover
    more than one block (the axes a gather of them spans)."""
    parts = x.sharding.parts(x.ndim)
    axes: List[str] = []
    for k in range(x.ndim):
        if parts[k] == 1:
            continue
        hit = set()
        for region in regions:
            start, size = region[k]
            for i in range(parts[k]):
                b0, bn = split_range(x.shape[k], parts[k], i)
                if max(b0, start) < min(b0 + bn, start + size):
                    hit.add(i)
        if len(hit) > 1:
            axes += [a for a in x.sharding._axes(k) if a not in axes]
    return tuple(axes)


def whole(x: Any, device: Any = None) -> torch.Tensor:
    """The whole leaf on ``device`` (by default its first block's)."""
    if device is None:
        device = (x.blocks[0] if is_blocked(x) else x).device
    return take(x, torch.device(device))


def filled(shape: Sequence[int], dtype: torch.dtype,
           sharding: NamedSharding, value: Optional[float] = 0.0) -> Any:
    """A new leaf of ``shape`` laid out as ``sharding``, each block
    allocated on its owner's device and filled with ``value`` (``None``:
    left unwritten); one block is a plain tensor, as :func:`block`
    stores it."""
    def one(region: Region, device: torch.device) -> torch.Tensor:
        size = tuple(n for _, n in region)
        if value is None:
            return torch.empty(size, dtype=dtype, device=device)
        return torch.full(size, value, dtype=dtype, device=device)

    devices = sharding.devices(shape)
    blocks = [one(region, dev) for (region, _), dev
              in zip(sharding.blocks(shape), devices)]
    if len(blocks) == 1:
        return blocks[0]
    return Blocked(blocks, sharding, shape)


def put(x: Any, region: Region, value: torch.Tensor) -> None:
    """Write ``value`` (shaped as ``region``) into the elements of ``x``
    (a tensor or a :class:`Blocked`) in ``region``, in place: each block
    it covers takes its part, copied to the block's device."""
    if not is_blocked(x):
        dst = x
        for dim, (lo, n) in enumerate(region):
            if n != x.shape[dim]:
                dst = dst.narrow(dim, lo, n)
        dst.copy_(value)
        return
    for (breg, _), blk in zip(x.sharding.blocks(x.shape), x.blocks):
        sub_dst, sub_src = [], []
        for (lo, n), (b0, bn) in zip(region, breg):
            a, b = max(lo, b0), min(lo + n, b0 + bn)
            if a >= b:
                break
            sub_dst.append((a - b0, b - a))
            sub_src.append((a - lo, b - a))
        else:
            put(blk, tuple(sub_dst), piece(value, tuple(sub_src), blk.device))


def _own(t: torch.Tensor, src: Sequence[torch.Tensor]) -> torch.Tensor:
    """``t`` as a tensor of its own: a copy where it is a strict view of a
    tensor in ``src`` (a stored block must not keep a larger one alive)."""
    ptr = t.untyped_storage().data_ptr()
    for s in src:
        if (s.untyped_storage().data_ptr() == ptr
                and t.numel() < s.untyped_storage().nbytes()
                // max(s.element_size(), 1)):
            return t.clone()
    return t


def block(x: Any, sharding: NamedSharding) -> Any:
    """``x`` (a tensor or a :class:`Blocked`) stored as ``sharding``'s
    blocks, each on its owner's device; a leaf the sharding replicates
    whole is one block, stored as a plain tensor on the mesh's first
    device.  A block that is already stored where it belongs is kept;
    every other is a copy of its own."""
    if is_blocked(x) and x.sharding == sharding:
        return x
    src = list(x.blocks) if is_blocked(x) else [x]
    devices = sharding.devices(x.shape)
    with torch.no_grad():
        if len(devices) == 1:
            return _own(whole(x, devices[0]), src)
        blocks = [_own(piece(x, region, dev), src)
                  for (region, _), dev in zip(sharding.blocks(x.shape),
                                              devices)]
    return Blocked(blocks, sharding, x.shape)


def lay_out(x: Any, sharding: Optional[NamedSharding]) -> Any:
    """``x`` as ``sharding`` says, or ``x`` itself without one."""
    return x if sharding is None else block(x, sharding)


def like(x: Any, ref: Any) -> Any:
    """Leaf ``x`` laid out as ``ref``: ``ref``'s blocks, or whole on
    ``ref``'s device."""
    if is_blocked(ref):
        return block(x, ref.sharding)
    if is_blocked(x):
        return whole(x, ref.device)
    return x.to(ref.device)


def tree_like(tree: Any, ref: Any) -> Any:
    """:func:`like` over two trees of one structure (leaves already laid
    out as ``ref``'s are returned as they are)."""
    return map_leaves(like, tree, ref)


def add_into(acc: Any, x: Any) -> Any:
    """``acc += x`` in ``acc``'s layout (``x`` re-laid out first where it
    lies otherwise), block by block; returns ``acc``."""
    x = like(x, acc)
    if is_blocked(acc):
        for a, b in zip(acc.blocks, x.blocks):
            a.add_(b)
    else:
        acc.add_(x)
    return acc


def stored_bytes(tree: Any) -> dict:
    """Bytes stored per device over the tree's tensors (a
    :class:`Blocked`'s blocks each on its own)."""
    out: dict = {}
    for t in pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            out[t.device] = out.get(t.device, 0) + t.numel() * t.element_size()
    return out


def unbind_layers(x: Blocked, n: int) -> List[Blocked]:
    """The first ``n`` layers of a layer-stacked ``[L, ...]`` leaf, each a
    :class:`Blocked` of views of the blocks (one ``unbind`` per block, whose
    backward stacks the layers' gradients once).  The ``L`` dim must be
    unsplit, as the sharding rules keep it."""
    if x.sharding.parts(x.ndim)[0] != 1:
        raise ValueError(f"{x}: the layer dim is split")
    sh = NamedSharding(x.sharding.mesh, tuple(x.sharding.spec[1:]))
    per_block = [torch.unbind(b[:n], 0) for b in x.blocks]
    return [Blocked([views[i] for views in per_block], sh, x.shape[1:])
            for i in range(n)]
