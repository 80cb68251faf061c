"""Sharding rules: map every parameter leaf to a spec on the (pod, data,
model) mesh, and split a parameter tree into its tensor-parallel shards.

Counterparts of ``sanitize``, ``spec_for_param``, ``_retarget``,
``serve_param_specs`` and ``kv_page_spec`` in
``repro/distributed/sharding.py``, with the same rules (DESIGN §5): FSDP
shards a parameter's d_model-like dim over ``data``; heads, d_ff, experts
and vocab shard over ``model``; layer-stacked leaves keep their leading
``L`` dim unsharded.  A spec is a tuple with one entry per dimension: an
axis name, a tuple of axis names, or ``None`` (replicated).  Paths are the
tuples of dict keys from the tree's root to the leaf.

:func:`shard_params` is the port's placement: one host process holds a
parameter tree per shard, each leaf cut along its tp dimension (a view of
the full leaf where the shard shares its device, a copy on another
device) and replicated leaves shared where the device is the same.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.mesh import ParallelPlan

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
    falls back to replicated); the result has one entry per dim."""
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if axis is not None and dim % _axis_size(plan, axis) != 0:
            axis = None
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


def kv_page_spec(plan: ParallelPlan) -> Spec:
    """Spec of the paged KV pools ``[L, n_pages, page, kv, hd]``: pages
    shard on the **kv-head dim**, so a page id means the same on every
    shard and the host-side block tables, refcounts and CoW plans stay
    device-agnostic; each shard copies only its slice of a faulted page."""
    return (None, None, None, plan.tp_axis, None)


def shard_leaf(x: torch.Tensor, spec: Spec, tp_axis: str, rank: int,
               tp: int, device: torch.device) -> torch.Tensor:
    """Shard ``rank`` of ``tp`` of one leaf on ``device``: the slice along
    the dim ``spec`` assigns to ``tp_axis`` (the whole leaf if none).  On
    the leaf's own device the slice is a view; elsewhere a copy."""
    for dim, axis in enumerate(spec):
        if axis == tp_axis:
            size = x.shape[dim] // tp
            x = x.narrow(dim, rank * size, size)
            break
    return x.to(device)


def shard_params(cfg: ArchConfig, plan: ParallelPlan, params: Params,
                 specs: Optional[Any] = None) -> List[Params]:
    """Split the full parameter tree into one tree per tp shard, each on
    its device (``plan.devices``), along ``specs`` (the serving specs by
    default)."""
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
