"""Plain reference of the decoder of ``decoder.py``, over weights that lie
in tensor-parallel blocks on several devices.

The same forward pass as ``decoder.py`` (whose functions it reuses), for a
model that no one device holds whole, not even in its served type: each
leaf is read where it lies, one block at a time, widened to float32 there.
A leaf is either a tensor (whole) or an object with ``parts`` (one tensor a
shard, on the shard's device) and ``axis`` (the dimension the leaf was cut
along, equal blocks in shard order; None where every part is the whole
leaf).  The split axes reach it as data; it imports torch, and nothing of
this repository but ``decoder.py`` beside it.

Each layer, with the residual stream in float32 on the first shard's
device:

* attention: on each shard's device, its heads' q, k and v, rotary
  positions and causal attention over its kv heads, and its slice of
  ``wo``; the shards' partial outputs brought to the first device and
  summed there in float32, in shard order;
* the FFN: the router (whole on every shard, as the norms and the
  embedding are) over the full width on the first device (softmax in
  float32, top ``experts_per_token`` gates renormalised), each expert
  computed on the device that holds it for the rows routed to it (every
  routed row: no capacity, no drop), the outputs gathered on the first
  device in expert order; a dense MLP's d_ff blocks each on their device,
  summed as attention's;
* the head over its vocabulary blocks, each on its device, the logits put
  together on the first device.

``precision`` names the control as in ``decoder.py``: every product's
operands rounded to a lower type first, a weight block's columns (and an
activation block's rows) scaled as that block holds them."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

import torch


def _sibling(name: str) -> Any:
    spec = importlib.util.spec_from_file_location(
        f"bench_reference_{name}", Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


D = _sibling("decoder")
LOWER = D.LOWER
gaps = D.gaps


def _blocks(leaf: Any) -> Tuple[List[torch.Tensor], Any]:
    """(each shard's block, the split axis); a whole leaf is one block."""
    if isinstance(leaf, torch.Tensor):
        return [leaf], None
    if leaf.axis is None:
        return [leaf.parts[0]], None
    return list(leaf.parts), leaf.axis


def _whole(leaf: Any) -> torch.Tensor:
    """A leaf every shard holds whole (norms, the embedding, the router)."""
    parts, axis = _blocks(leaf)
    assert axis is None, "a leaf the serving specs keep whole"
    return parts[0]


def _at(leaf: Any, i: int) -> Tuple[List[torch.Tensor], Any]:
    """Layer ``i``'s blocks of a layer-stacked leaf, and their axis."""
    parts, axis = _blocks(leaf)
    return [p[i] for p in parts], None if axis is None else axis - 1


class _Copies:
    """One float32 copy of an activation on each device that asks."""

    def __init__(self, x: torch.Tensor):
        self.x = x
        self.on: Dict[torch.device, torch.Tensor] = {x.device: x}

    def __getitem__(self, dev: torch.device) -> torch.Tensor:
        if dev not in self.on:
            self.on[dev] = self.x.to(dev)
        return self.on[dev]


def _sum(parts: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def _attention(m: Dict[str, Any], a: Dict[str, Any], i: int, x: _Copies,
               offs: List[int], hd: int, precision: str) -> torch.Tensor:
    """Layer ``i``'s attention output: each shard's partial, summed on the
    stream's device."""
    names = ("q", "k", "v")
    ws = [_at(a["w" + n], i)[0] for n in names]
    wo = _at(a["wo"], i)[0]
    bias = m.get("qkv_bias")
    bs = [_at(a["b" + n], i)[0] for n in names] if bias else None
    out = []
    for r in range(len(wo)):
        dev = wo[r].device
        xr = x[dev]
        lp = {"w" + n: ws[j][r] for j, n in enumerate(names)}
        if bias:
            lp.update({"b" + n: bs[j][r] for j, n in enumerate(names)})
        q, k, v = (D._project(lp, n, xr, precision, bias)
                   .view(xr.shape[0], -1, hd) for n in names)
        o = torch.cat([
            D.causal_attention(D.rope(q[o0:o1], m["rope_theta"]),
                               D.rope(k[o0:o1], m["rope_theta"]), v[o0:o1])
            for o0, o1 in zip(offs[:-1], offs[1:])]).reshape(xr.shape[0], -1)
        del q, k, v
        out.append(D._Linear(wo[r].reshape(-1, wo[r].shape[-1]),
                             precision)(o))
        del o
    return _sum(out, x.x.device)


def _experts(m: Dict[str, Any], p: Dict[str, Any], i: int, x: _Copies,
             precision: str) -> torch.Tensor:
    """Softmax router in float32 on the stream's device, top-k gates
    renormalised; each expert on its block's device over the rows routed to
    it, its outputs added on the stream's device in expert order."""
    x0 = x.x
    dev0 = x0.device
    router = _whole(p["router"])[i].to(dev0)
    probs = torch.softmax(x0 @ router.float(), dim=-1)
    gate, ids = torch.topk(probs, m["experts_per_token"], dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    blocks = {n: _at(p[n], i)[0] for n in ("wg", "wu", "wd")}
    # expert e lies in block e // per at index e % per
    per = blocks["wg"][0].shape[0]
    # every expert's rows reach its device before any expert is computed: a
    # copy from the host waits for the device's queue to drain, and would
    # leave one device at work at a time
    ids = ids.cpu()
    routed = []
    for e in range(m["num_experts"]):
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        if rows.numel():
            w = {n: b[e // per][e % per] for n, b in blocks.items()}
            dev = w["wg"].device
            routed.append((w, rows.to(dev), rows.to(dev0), slot.to(dev0)))
    ys = [D.mlp(m, w, x[r.device][r], precision)
          for w, r, _, _ in routed]
    out = torch.zeros_like(x0)
    for (_, _, rows, slot), y in zip(routed, ys):
        out.index_add_(0, rows, y.to(dev0) * gate[rows, slot, None])
    return out


def _mlp(m: Dict[str, Any], p: Dict[str, Any], i: int, x: _Copies,
         precision: str) -> torch.Tensor:
    """A dense MLP's d_ff blocks, each on its device, summed."""
    blocks = {n: _at(p[n], i)[0] for n in ("wg", "wu", "wd")}
    out = []
    for r in range(len(blocks["wd"])):
        w = {n: b[r] for n, b in blocks.items()}
        out.append(D.mlp(m, w, x[w["wd"].device], precision))
    return _sum(out, x.x.device)


class _Head:
    """The head's vocabulary blocks (``lm_head`` ``[d, V]``, or the
    embedding ``[V, d]``'s transpose where tied), each widened once on its
    device."""

    def __init__(self, m: Dict[str, Any], weights: Dict[str, Any],
                 precision: str):
        tied = m.get("tie_embeddings")
        parts, self.axis = _blocks(weights["embed"] if tied
                                   else weights["lm_head"])
        self.blocks = [D._Linear(w.T if tied else w, precision)
                       for w in parts]

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        """Logits ``[rows, V]`` on ``h``'s device."""
        x = _Copies(h)
        out = [lin(x[lin.w.device]) for lin in self.blocks]
        if self.axis is None:
            return out[0]
        return torch.cat([o.to(h.device) for o in out], dim=-1)


def score(m: Dict[str, Any], weights: Dict[str, Any],
          seqs: Sequence[Sequence[int]], starts: Sequence[int], *,
          precision: str = "float32") -> List[torch.Tensor]:
    """Float32 logits ``[len(seq) - start, vocab]`` of each sequence at its
    positions ``start ..``, as ``decoder.score`` gives them, the weights
    read block by block where they lie."""
    D.set_exact()
    eps = m.get("norm_eps", 1e-5)
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    lens = [len(s) for s in seqs]
    offs = [sum(lens[:j]) for j in range(len(lens) + 1)]
    embed = _whole(weights["embed"])
    ids = torch.tensor([t for s in seqs for t in s], device=embed.device)
    h = embed[ids].float()
    layers = weights["layers"]
    for i in range(m["num_layers"]):
        x = _Copies(D.rms_norm(h, _whole(layers["ln1"])[i], eps))
        h = h + _attention(m, layers["attn"], i, x, offs, hd, precision)
        del x
        x = _Copies(D.rms_norm(h, _whole(layers["ln2"])[i], eps))
        if m.get("num_experts"):
            h = h + _experts(m, layers["moe"], i, x, precision)
        else:
            h = h + _mlp(m, layers["mlp"], i, x, precision)
        del x
    norm = _whole(weights["final_norm"])
    head = _Head(m, weights, precision)
    return [head(D.rms_norm(h[o0 + st:o1], norm, eps))
            for o0, o1, st in zip(offs[:-1], offs[1:], starts)]
