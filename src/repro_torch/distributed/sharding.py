"""Sharding rules: map every parameter, batch and cache leaf to a spec on
the (pod, data, model) mesh, and split a parameter tree into its
tensor-parallel shards.

Counterparts of ``sanitize``, ``spec_for_param``, ``param_shardings``,
``shard_params``, ``batch_spec``/``batch_shardings``,
``cache_spec``/``state_shardings``, ``_retarget``, ``serve_param_specs``
and ``kv_page_spec`` in ``repro/distributed/sharding.py``, with the same
rules (DESIGN §5): FSDP shards a parameter's d_model-like dim over
``data``; heads, d_ff, experts and vocab shard over ``model``;
layer-stacked leaves keep their leading ``L`` dim unsharded; batches
shard over ``(pod, data)``.  A spec is a tuple with one entry per
dimension: an axis name, a tuple of axis names, or ``None`` (replicated).
Paths are the tuples of dict keys from the tree's root to the leaf.

Placement.  For a serving plan :func:`shard_params` holds a parameter tree
per tp shard, each leaf cut along its tp dimension (a view of the full
leaf where the shard shares its device, a copy on another device);
:class:`ShardDraw` cuts an init's leaves the same way as they are drawn,
so no device holds the whole tree, and :func:`check_shards` holds trees
placed so against the serving specs.  For a
training plan it stores each leaf as the blocks :func:`param_shardings`
names (:class:`~repro_torch.distributed.blocked.Blocked`), each on the
device of the first position that holds it, and :func:`position_params`
gives each mesh position its part of a layer at use: the pieces of the
blocks it covers, gathered onto its device, which autograd differentiates
through back into the blocks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.blocked import block, map_leaves, take
from repro_torch.distributed.mesh import (
    NamedSharding,
    ParallelPlan,
    same_device,
    split_range,
)

Spec = Tuple[Any, ...]
Path = Tuple[str, ...]
Params = Dict[str, Any]


def tree_map_with_path(fn: Callable[[Path, Any], Any], tree: Any,
                       path: Path = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def _axis_size(plan: ParallelPlan, axis: Any) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= plan.mesh.shape[a]
        return n
    return plan.mesh.shape[axis]


def sanitize(plan: ParallelPlan, spec: Spec, shape: Tuple[int, ...]) -> Spec:
    """Drop axis assignments whose size does not divide the dim (the dim
    falls back to replicated); the result has one entry per dim, a tuple of
    one axis written as that axis (as ``PartitionSpec`` writes it)."""
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if axis is not None and dim % _axis_size(plan, axis) != 0:
            axis = None
        if isinstance(axis, (tuple, list)):
            axis = axis[0] if len(axis) == 1 else tuple(axis)
        out.append(axis)
    return tuple(out)


def spec_for_param(cfg: ArchConfig, path: Path, shape: Tuple[int, ...]
                   ) -> Spec:
    """Spec for one parameter leaf (layer-stacked leaves have a leading L
    dim that stays unsharded): the JAX package's training rules."""
    name = path[-1]
    lead = (None,) if "layers" in path else ()

    def with_lead(*spec: Any) -> Spec:
        return lead + spec

    if name == "embed":
        # vocab dim replicated (an embedding gather with a vocab-sharded
        # operand rematerialises it); d over data keeps it FSDP'd
        if len(shape) == 3:            # [cb, V, d]
            return (None, None, "data")
        return (None, "data")          # [V, d]
    if name == "lm_head":
        return ("data", "model")
    if name == "frontend_proj":
        return ("data", "model")
    if name == "final_norm":
        return (None,)
    if name == "w_concat":             # hybrid shared block [2d, d]
        return ("data", None)

    # attention
    if name == "wq":
        return with_lead("data", "model", None)
    if name in ("wk", "wv"):
        return with_lead("data", "model", None)
    if name == "wo":
        return with_lead("model", None, "data")
    if name in ("bq", "bk", "bv"):
        return with_lead("model", None)

    # dense MLP and MoE experts
    if name in ("wu", "wg", "wd"):
        if len(shape) - len(lead) == 3:            # MoE experts [E, d, f]
            if name == "wd":
                return with_lead("model", None, "data")
            return with_lead("model", "data", None)
        if name == "wd":                           # [f, d]
            return with_lead("model", "data")
        return with_lead("data", "model")          # [d, f]
    if name == "router":
        return with_lead("data", None)

    # mamba
    if name == "in_proj":
        return with_lead("data", "model")
    if name == "out_proj":
        return with_lead("model", "data")
    if name == "conv_w":
        return with_lead("model", None)
    if name == "conv_b":
        return with_lead("model")
    if name in ("A_log", "D", "dt_bias"):
        return with_lead("model")
    if name == "norm_w":
        return with_lead("model")
    if name in ("ln", "ln1", "ln2"):
        return with_lead(None)

    # fallback: replicate
    return lead + (None,) * (len(shape) - len(lead))


def param_shardings(cfg: ArchConfig, plan: ParallelPlan, params: Any,
                    zero1: bool = False, drop_data: bool = False) -> Any:
    """:class:`NamedSharding` tree matching ``params`` (``None`` leaves
    without a mesh).  Also right for optimizer-state trees that mirror the
    parameter tree (AdamW's ``mu``/``nu``): the rules key off leaf names
    and ranks.  With ``zero1`` (or for mu/nu leaves on a mesh with a
    ``pod`` axis) the FSDP dim shards over ``("pod", "data")``;
    ``drop_data`` replicates over ``data`` (TP-only residency)."""
    if plan.mesh is None:
        return tree_map_with_path(lambda path, leaf: None, params)
    has_pod = "pod" in plan.mesh.axis_names

    def one(path: Path, leaf: torch.Tensor) -> NamedSharding:
        shape = tuple(leaf.shape)
        spec = spec_for_param(cfg, path, shape)
        if has_pod and (zero1 or "mu" in path or "nu" in path):
            spec = tuple(("pod", "data") if a == "data" else a
                         for a in spec)
        if drop_data:
            spec = tuple(None if a == "data" else a for a in spec)
        return NamedSharding(plan.mesh, sanitize(plan, spec, shape))

    return tree_map_with_path(one, params)


def batch_spec(cfg: ArchConfig, plan: ParallelPlan, name: str,
               ndim: int) -> Spec:
    """Batch-major inputs (tokens, targets, frontend_embed) shard their
    batch dim over the data axes; ``pos`` is ``[b]``."""
    dp = plan.dp
    if name == "pos":
        return (dp,)
    return (dp,) + (None,) * (ndim - 1)


def batch_shardings(cfg: ArchConfig, plan: ParallelPlan,
                    batch: Dict[str, Any]) -> Dict[str, Any]:
    if plan.mesh is None:
        return {k: None for k in batch}
    return {k: NamedSharding(plan.mesh, sanitize(
        plan, batch_spec(cfg, plan, k, len(v.shape)), tuple(v.shape)))
            for k, v in batch.items()}


def cache_spec(cfg: ArchConfig, plan: ParallelPlan, name: str,
               shape: Tuple[int, ...]) -> Spec:
    """Decode-cache leaves: KV ``[L, b, S, kv, hd]`` shards batch over
    ``data`` and sequence over ``model``; the conv state ``[L, b, ck-1,
    conv_dim]`` its channels over ``model``; the SSM state ``[L, b, H, N,
    P]`` its heads over ``model``."""
    if name in ("k", "v"):
        return (None, "data", "model", None, None)
    if name == "conv":
        return (None, "data", None, "model")
    if name == "ssm":
        return (None, "data", "model", None, None)
    return (None,) * len(shape)


def state_shardings(cfg: ArchConfig, plan: ParallelPlan,
                    cache: Dict[str, Any]) -> Dict[str, Any]:
    if plan.mesh is None:
        return {k: None for k in cache}
    return {k: NamedSharding(plan.mesh, sanitize(
        plan, cache_spec(cfg, plan, k, tuple(v.shape)), tuple(v.shape)))
            for k, v in cache.items()}


# ---------------------------------------------------------------------------
# training: each mesh position's block of the parameters
# ---------------------------------------------------------------------------

def _model_dim(cfg: ArchConfig, path: Path, shape: Tuple[int, ...]
               ) -> Optional[int]:
    spec = spec_for_param(cfg, path, shape)
    return spec.index("model") if "model" in spec else None


#: the Mamba2 block's leaves, split over the model axis by meaning
MAMBA_LEAVES = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                "norm_w", "out_proj")


def mamba_ranges(cfg: ArchConfig, name: str, rank: int, tp: int
                 ) -> List[Tuple[int, int]]:
    """Tp rank ``rank``'s ranges of a Mamba2 leaf along its model dim: its
    heads (:func:`split_range` of the SSD heads), so ``in_proj``'s columns
    of z, of x and of dt for those heads and all of B and C (one group,
    which every rank uses); ``conv_w``/``conv_b``'s channels of x for those
    heads and of B and C; the heads of ``A_log``, ``D`` and ``dt_bias``;
    and the channels of ``norm_w`` and rows of ``out_proj`` for those
    heads.  The JAX package's even split of these leaves over ``model`` is
    its storage layout only: the function is the single-device one."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.ssm_d_inner
    h0, nh = split_range(H, tp, rank)
    if not nh:
        raise ValueError(f"tp={tp} splits {H} SSD heads so that rank "
                         f"{rank} has none")
    c = (h0 * P, nh * P)
    bc = (di, 2 * cfg.ssm_groups * N)
    if name == "in_proj":
        return [c, (di + c[0], c[1]), (2 * di, bc[1]),
                (2 * di + bc[1] + h0, nh)]
    if name in ("conv_w", "conv_b"):
        return [c, bc]
    if name in ("A_log", "D", "dt_bias"):
        return [(h0, nh)]
    return [c]                                      # norm_w, out_proj


#: the attention block's leaves, split over the model axis by head
ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def kv_range(cfg: ArchConfig, rank: int, tp: int
              ) -> Optional[Tuple[int, int]]:
    """The kv heads tp rank ``rank``'s query heads (:func:`split_range`)
    use, as (start, count), where they lie in one kv group or span whole
    groups; ``None`` where they do not (or the rank has none)."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    q0, nq = split_range(h, tp, rank)
    g = h // kv
    k0, k1 = q0 // g, -(-(q0 + nq) // g)
    if nq and (k1 - k0 == 1 or (q0 % g == 0 and nq % g == 0)):
        return k0, k1 - k0
    return None


def heads_split(cfg: ArchConfig, tp: int) -> bool:
    """Whether ``tp`` ranks split the attention heads: every rank's query
    heads lie in one kv group or span whole groups.  Where they do not
    (6 heads over 2 kv heads at tp 4: rank 1's heads [2, 4) span two groups
    in part; qwen2-1.5b's 12 over 2 at 16), the attention block runs whole
    on every rank, as the JAX package's ``sanitize`` replicates its leaves
    (the heads dim does not divide), and its output is added once."""
    return all(kv_range(cfg, r, tp) is not None for r in range(tp))


def rank_ranges(cfg: ArchConfig, path: Path, shape: Tuple[int, ...],
                rank: int, tp: int
                ) -> Tuple[Optional[int], List[Tuple[int, int]]]:
    """(dim, ranges) of tp rank ``rank`` of ``tp``'s part of one leaf of a
    layer (or of the top-level tree): along its ``model`` dim
    (:func:`spec_for_param`), contiguous parts (:func:`split_range`:
    heads, d_ff, experts, vocab); the kv-head leaves follow the query
    heads (a rank whose heads lie in one kv group takes that kv head, one
    whose heads span whole groups takes theirs), and the attention leaves
    are whole where the heads do not split (:func:`heads_split`); the
    Mamba2 leaves split by meaning (:func:`mamba_ranges`).  ``(None,
    [])``: the whole leaf."""
    name = path[-1]
    dim = _model_dim(cfg, path, shape)
    if tp == 1 or dim is None:
        return None, []
    if name in MAMBA_LEAVES:
        return dim, mamba_ranges(cfg, name, rank, tp)
    if name in ATTN_LEAVES and not heads_split(cfg, tp):
        return None, []
    if name in ("wk", "wv", "bk", "bv"):
        return dim, [kv_range(cfg, rank, tp)]
    return dim, [split_range(shape[dim], tp, rank)]


def position_params(cfg: ArchConfig, params: Params, rank: int, tp: int,
                    device: torch.device, path: Path = ()) -> Params:
    """Tp rank ``rank`` of ``tp``'s part of a parameter tree on ``device``,
    for a training forward: one layer's tree (the leaves of
    ``p["layers"]`` at one layer, or the hybrid's shared block) or the
    top-level leaves, each leaf's :func:`rank_ranges` taken from its
    tensor or its blocks (:func:`blocked.take`).  The data axes cut
    nothing: FSDP's gather at use is the whole of those dims.  A view
    where the part lies in one block on ``device``, a copy otherwise;
    either way differentiable into the stored leaf."""
    def one(p: Path, x: Any) -> torch.Tensor:
        dim, ranges = rank_ranges(cfg, path + p, tuple(x.shape), rank, tp)
        return take(x, device, dim, ranges)

    return tree_map_with_path(one, params)


# ---------------------------------------------------------------------------
# serving (tensor-parallel decode over paged KV)
# ---------------------------------------------------------------------------

def _retarget(spec: Spec, tp_axis: str) -> Spec:
    """Map the training rules onto a serving plan: ``model`` becomes the
    plan's tp axis and ``data``/``pod`` (and axis tuples) are dropped:
    inference keeps TP-only residency."""
    def one(a: Any) -> Any:
        if a in ("data", "pod") or isinstance(a, (tuple, list)):
            return None
        return tp_axis if a == "model" else a
    return tuple(one(a) for a in spec)


def serve_param_specs(cfg: ArchConfig, plan: ParallelPlan,
                      params: Any) -> Any:
    """The spec tree of the serving hot loop: the training rules with the
    tp axis retargeted onto ``plan.tp_axis`` and every data/FSDP
    assignment dropped: attention heads, kv heads, d_ff and experts shard
    over tp; norms, embeddings and the router replicate.  A non-dividing
    dim falls back to replicated (:func:`sanitize`); the dims a reduction
    depends on (kv heads, heads, d_ff, experts) are checked up front by
    the engine, so the fallback never breaks a sum."""
    def one(path: Path, leaf: torch.Tensor) -> Spec:
        spec = _retarget(spec_for_param(cfg, path, tuple(leaf.shape)),
                         plan.tp_axis)
        return sanitize(plan, spec, tuple(leaf.shape))

    return tree_map_with_path(one, params)


def kv_split(cfg: ArchConfig, tp: int) -> bool:
    """Whether the engine splits the attention heads and the pools' kv
    heads over ``tp`` shards: both counts divide ``tp``.  Otherwise every
    shard holds every head and the whole pools, computes the whole block,
    and shard 0's output is added once (as the JAX package's ``sanitize``
    replicates a dim that does not divide)."""
    return cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0


def serve_specs(cfg: ArchConfig, plan: ParallelPlan, params: Any) -> Any:
    """The serving engine's parameter spec tree (the training rules
    retargeted to the serving tp axis).  A multi-codebook head keeps its
    vocab dim replicated: the ``[b, s, cb, V]`` unflatten in ``lm_head``
    needs the full codebook-major vocab on every shard.  The attention
    leaves replicate where :func:`kv_split` does not split the heads."""
    specs = serve_param_specs(cfg, plan, params)
    if cfg.num_codebooks > 1 and "lm_head" in specs:
        specs["lm_head"] = (None,) * params["lm_head"].dim()
    if not kv_split(cfg, plan.tp_size):
        specs["layers"]["attn"] = {
            k: (None,) * len(v) for k, v in specs["layers"]["attn"].items()}
    return specs


def kv_page_spec(plan: ParallelPlan) -> Spec:
    """Spec of the paged KV pools ``[L, n_pages, page, kv, hd]``: pages
    shard on the **kv-head dim**, so a page id means the same on every
    shard and the host-side block tables, refcounts and CoW plans stay
    device-agnostic; each shard copies only its slice of a faulted page."""
    return (None, None, None, plan.tp_axis, None)


def _tp_dim(spec: Spec, tp_axis: str) -> Optional[int]:
    return spec.index(tp_axis) if tp_axis in spec else None


def shard_shape(shape: Tuple[int, ...], spec: Spec, tp_axis: str,
                tp: int) -> Tuple[int, ...]:
    """The shape of each of ``tp`` shards of a leaf of ``shape``: its dim
    along ``tp_axis`` divided by ``tp``."""
    dim = _tp_dim(spec, tp_axis)
    if dim is None:
        return tuple(shape)
    return tuple(n // tp if i == dim else n for i, n in enumerate(shape))


def _narrow(x: torch.Tensor, spec: Spec, tp_axis: str, rank: int,
            tp: int) -> torch.Tensor:
    """Shard ``rank`` of ``tp`` of one leaf as a view: the slice along the
    dim ``spec`` assigns to ``tp_axis`` (the whole leaf if none)."""
    dim = _tp_dim(spec, tp_axis)
    if dim is None:
        return x
    size = x.shape[dim] // tp
    return x.narrow(dim, rank * size, size)


def shard_leaf(x: torch.Tensor, spec: Spec, tp_axis: str, rank: int,
               tp: int, device: torch.device) -> torch.Tensor:
    """Shard ``rank`` of ``tp`` of one leaf on ``device``: the slice along
    the dim ``spec`` assigns to ``tp_axis`` (the whole leaf if none).  On
    the leaf's own device the slice is a view; elsewhere a copy."""
    return _narrow(x, spec, tp_axis, rank, tp).to(device)


class WholeDraw:
    """Where an init puts each leaf it draws by default: whole, on the
    drawing device (the interface :class:`ShardDraw` shares)."""

    def leaf(self, path: Path, x: torch.Tensor) -> torch.Tensor:
        """A top-level leaf, as drawn."""
        return x

    def alloc(self, path: Path, x: torch.Tensor, n: int) -> torch.Tensor:
        """An empty ``[n, ...]`` stack for layer draws like ``x``."""
        return x.new_empty((n, *x.shape))

    def fill(self, path: Path, dst: torch.Tensor, i: int,
             x: torch.Tensor) -> None:
        """Layer ``i``'s draw ``x`` into the stack."""
        dst[i].copy_(x)

    def trees(self, tree: Params) -> Params:
        """The drawn tree, as it is."""
        return tree


#: the default placement of an init: every leaf whole where it is drawn
WHOLE = WholeDraw()


class ShardDraw:
    """Where an init puts each leaf it draws when no device may hold the
    whole tree (``Model.init(generator, shards=plan)``): cut into the
    serving plan's tp shards along ``specs`` (:func:`serve_specs` of the
    whole tree's shapes), each shard sent to its device at once, so the
    draw can be dropped before the next one.  A shard on the drawing
    device is a copy where it is a part of the leaf (a view would keep the
    whole draw alive).  The values are :func:`shard_params`' of the whole
    init from the same generator, bit for bit: the draws, their order and
    the cuts are the same."""

    def __init__(self, plan: ParallelPlan, specs: Any):
        if plan.dp_axes or not plan.is_distributed:
            raise ValueError("a shard-by-shard draw takes a serving plan "
                             "(a tp axis and no data axes)")
        self.plan = plan
        self.specs = specs

    def leaf(self, path: Path, x: torch.Tensor) -> List[torch.Tensor]:
        """A top-level leaf: each shard's part on its device."""
        spec, plan = _at(self.specs, path), self.plan
        out = []
        for rank, dev in enumerate(plan.devices):
            part = _narrow(x, spec, plan.tp_axis, rank, plan.tp_size)
            if part.shape != x.shape and same_device(part.device, dev):
                part = part.clone()
            out.append(part.to(dev))
        return out

    def alloc(self, path: Path, x: torch.Tensor, n: int
              ) -> List[torch.Tensor]:
        """Each shard's empty ``[n, ...]`` stack for layer draws like
        ``x`` (``path`` is the stacked leaf's, its spec's first entry the
        unsharded layer dim)."""
        spec = _at(self.specs, path)[1:]
        shape = shard_shape(tuple(x.shape), spec, self.plan.tp_axis,
                            self.plan.tp_size)
        return [torch.empty((n, *shape), dtype=x.dtype, device=dev)
                for dev in self.plan.devices]

    def fill(self, path: Path, dst: List[torch.Tensor], i: int,
             x: torch.Tensor) -> None:
        """Layer ``i``'s draw ``x`` into each shard's stack."""
        spec, plan = _at(self.specs, path)[1:], self.plan
        for rank, d in enumerate(dst):
            d[i].copy_(_narrow(x, spec, plan.tp_axis, rank, plan.tp_size))

    def trees(self, tree: Any) -> List[Params]:
        """The tree of per-shard lists as one tree per shard."""
        return [tree_map_with_path(lambda path, parts: parts[rank], tree)
                for rank in range(self.plan.tp_size)]


#: how an init places what it draws (:class:`WholeDraw` or
#: :class:`ShardDraw`)
Placement = Union[WholeDraw, ShardDraw]


def check_shards(plan: ParallelPlan, specs: Any, like: Any,
                 trees: Sequence[Any]) -> None:
    """Raise unless ``trees`` is one parameter tree per tp shard of the
    serving plan, each leaf of the shape ``specs`` cuts from ``like``'s
    (the whole tree, or its shapes on ``meta``), of its type and on its
    shard's device."""
    if len(trees) != plan.tp_size:
        raise ValueError(f"{len(trees)} shard trees for tp={plan.tp_size}")
    for rank, (dev, tree) in enumerate(zip(plan.devices, trees)):
        def one(path: Path, x: Any) -> None:
            try:
                got = _at(tree, path)
            except (KeyError, TypeError):
                raise ValueError(f"shard {rank} has no leaf "
                                 f"{'.'.join(path)}") from None
            want = shard_shape(tuple(x.shape), _at(specs, path),
                               plan.tp_axis, plan.tp_size)
            if (not isinstance(got, torch.Tensor)
                    or tuple(got.shape) != want or got.dtype != x.dtype
                    or not same_device(got.device, dev)):
                what = (f"{tuple(got.shape)} {got.dtype} on {got.device}"
                        if isinstance(got, torch.Tensor) else type(got))
                raise ValueError(
                    f"shard {rank}'s {'.'.join(path)} is {what}; the "
                    f"serving specs want {want} {x.dtype} on {dev}")
        tree_map_with_path(one, like)


def shard_params(cfg: ArchConfig, plan: ParallelPlan, params: Params,
                 specs: Optional[Any] = None) -> Any:
    """A serving plan (no data axes): the full parameter tree split into
    one tree per tp shard, each on its device (``plan.devices``), along
    ``specs`` (the serving specs by default).  A training plan: the tree
    with each leaf stored as :func:`param_shardings`' blocks (a tree of
    :class:`~repro_torch.distributed.blocked.Blocked`; a tree already
    stored as blocks is re-laid out, a leaf already in place kept)."""
    if plan.dp_axes:
        sh = param_shardings(cfg, plan, params)
        return map_leaves(block, params, sh)
    if specs is None:
        specs = serve_param_specs(cfg, plan, params)
    out = []
    for rank, dev in enumerate(plan.devices):
        out.append(tree_map_with_path(
            lambda path, leaf: shard_leaf(leaf, _at(specs, path),
                                          plan.tp_axis, rank, plan.tp_size,
                                          dev), params))
    return out


def _at(tree: Any, path: Path) -> Any:
    for k in path:
        tree = tree[k]
    return tree
