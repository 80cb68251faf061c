"""The work a model pass needs, counted from logical shapes, and the chip's
published peaks.

Counts follow the model's equations, not what a kernel happens to do: each
input byte of a kernel call read once and each output byte written once,
each matrix product's two operations per multiply-add.  A kernel's least
time is the larger of its operations over the peak rate and its bytes over
the peak bandwidth."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_FLOPS: Dict[str, float] = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "float32": 67e12,
}
PEAK_BYTES_PER_S = 3.35e12

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass(frozen=True)
class Shape:
    """The model sizes the formulas need (from a configuration file)."""

    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    experts: int = 0
    experts_per_token: int = 0
    gated: bool = True
    dtype: str = "bfloat16"

    @classmethod
    def of(cls, model: Dict) -> "Shape":
        hd = model.get("head_dim") or model["d_model"] // model["num_heads"]
        return cls(layers=model["num_layers"], d_model=model["d_model"],
                   heads=model["num_heads"], kv_heads=model["num_kv_heads"],
                   head_dim=hd, d_ff=model["d_ff"],
                   vocab=model["vocab_size"],
                   experts=model.get("num_experts", 0),
                   experts_per_token=model.get("experts_per_token", 0),
                   gated=model.get("mlp_activation", "swiglu") != "sqrelu",
                   dtype=model.get("dtype", "bfloat16"))

    @property
    def layer_matmul_params(self) -> int:
        """Weights one token multiplies through in one layer: q, k, v, o,
        and the FFN (the experts it is routed to, and the router)."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (2 * self.heads + 2 * self.kv_heads)
        ffn = (3 if self.gated else 2) * d * self.d_ff
        if self.experts:
            return attn + self.experts_per_token * ffn + d * self.experts
        return attn + ffn

    @property
    def head_params(self) -> int:
        return self.d_model * self.vocab


def token_flops(shape: Shape, context: int, *, logits: bool) -> float:
    """Model FLOPs of one token whose attention reads ``context`` positions
    (itself included): every layer's products, QK^T and PV, and the head
    where the pass computes this token's logits."""
    per_layer = (2 * shape.layer_matmul_params
                 + 4 * context * shape.heads * shape.head_dim)
    return (shape.layers * per_layer
            + (2 * shape.head_params if logits else 0))


def prefill_flops(shape: Shape, cached: int, new: int) -> float:
    """Model FLOPs of a prefill of ``new`` tokens after ``cached`` ones
    (no logits: the pass only fills the cache)."""
    # sum over the new tokens of their context lengths cached + i + 1
    ctx_sum = new * cached + new * (new + 1) // 2
    return shape.layers * (2 * shape.layer_matmul_params * new
                           + 4 * ctx_sum * shape.heads * shape.head_dim)


def paged_attention_bound_s(shape: Shape, rows: int, t: int,
                            ctx_sum: int, distinct: int = 0) -> float:
    """K1's least time for one call over all layers: ``rows`` sequences of
    ``t`` new tokens each, ``ctx_sum`` the sum over rows of the positions
    each row's last token reads (cached + t), ``distinct`` the positions
    they read with a page that rows share counted once (``ctx_sum`` where
    not given).  Bytes: every K/V position read once, q and the output
    once; operations: QK^T and PV of each query over its causal context."""
    hd, e = shape.head_dim, BYTES[shape.dtype]
    kv_bytes = (distinct or ctx_sum) * shape.kv_heads * hd * 2 * e
    qo_bytes = rows * t * shape.heads * hd * 2 * e
    # a row's t queries read ctx - t + 1 .. ctx positions
    reads = ctx_sum * t - rows * t * (t - 1) // 2
    flops = 4 * reads * shape.heads * hd
    return shape.layers * max(flops / PEAK_FLOPS[shape.dtype],
                              (kv_bytes + qo_bytes) / PEAK_BYTES_PER_S)


def decode_flops(shape: Shape, rows: int, ctx_sum: int) -> float:
    """Model FLOPs of one decode step of ``rows`` sequences whose contexts
    (the new token included) sum to ``ctx_sum``; every row's logits."""
    return (rows * token_flops(shape, 0, logits=True)
            + shape.layers * 4 * ctx_sum * shape.heads * shape.head_dim)
