"""Architecture configuration schema + registry.

Every assigned architecture is a frozen :class:`ArchConfig`; the registry
maps ``--arch <id>`` to it.  ``reduced()`` produces the tiny same-family
config used by CPU tests.  The port's copy of the JAX package's
``repro/configs/base.py``; the port serves every configuration the JAX
package registers: ``paper-agentic``, ``qwen2-1.5b``, ``granite-8b``,
``nemotron-4-15b`` and ``stablelm-12b`` (dense), ``pixtral-12b`` (VLM stub),
``musicgen-medium`` (audio, four codebooks), ``mamba2-2.7b`` (SSM),
``zamba2-7b`` (hybrid), ``qwen3-moe-235b-a22b`` and ``dbrx-132b`` (MoE).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                  # query heads (0 => attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads
    # ---- MLP / attention variants -------------------------------------
    mlp_activation: str = "swiglu"  # swiglu | sqrelu | geglu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    # ---- MoE -----------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # ---- SSM (Mamba2 / SSD) ---------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv_kernel: int = 4
    ssm_groups: int = 1
    # ---- hybrid (zamba-style shared attention) --------------------------
    attn_every: int = 0             # 0 => pure; k => shared attn block @ k
    # ---- modality frontends (stubs) --------------------------------------
    frontend: str = "none"          # none | vlm_stub | audio_stub
    frontend_tokens: int = 0        # prefix positions fed by the stub
    num_codebooks: int = 1          # musicgen: parallel EnCodec codebooks
    # ---- numerics ---------------------------------------------------------
    dtype: str = "bfloat16"
    # provenance: [source; verified-tier]
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.num_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def ssm_conv_dim(self) -> int:
        # x, B, C are all convolved (Mamba2 layout)
        return self.ssm_d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def n_attn_layers(self) -> int:
        """How many attention applications one forward pass makes."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            return self.num_layers // max(self.attn_every, 1)
        return self.num_layers

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs (SSM/hybrid) run the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    # ------------------------------------------------------------------
    # parameter counting (used by roofline MODEL_FLOPS = 6·N·D)
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n = 0
        # embeddings (+ output head unless tied)
        n += self.num_codebooks * v * d
        n += 0 if self.tie_embeddings else d * v * self.num_codebooks
        if self.frontend != "none":
            n += d * d  # stub frontend projection

        def attn_params() -> int:
            p = d * self.num_heads * hd          # q
            p += 2 * d * self.num_kv_heads * hd  # k, v
            p += self.num_heads * hd * d         # o
            if self.qkv_bias:
                p += (self.num_heads + 2 * self.num_kv_heads) * hd
            return p

        def mlp_params(ff: int) -> int:
            mults = 3 if self.mlp_activation in ("swiglu", "geglu") else 2
            return mults * d * ff

        if self.family == "ssm":
            di, cdim = self.ssm_d_inner, self.ssm_conv_dim
            per = d * (2 * di + 2 * self.ssm_groups * self.ssm_state
                       + self.ssm_heads)          # in_proj
            per += cdim * self.ssm_conv_kernel    # conv
            per += 2 * self.ssm_heads             # A, D
            per += di                              # gated norm
            per += di * d                          # out_proj
            per += 2 * d                           # norms
            n += self.num_layers * per
        elif self.family == "hybrid":
            di, cdim = self.ssm_d_inner, self.ssm_conv_dim
            per = d * (2 * di + 2 * self.ssm_groups * self.ssm_state
                       + self.ssm_heads)
            per += cdim * self.ssm_conv_kernel
            per += 2 * self.ssm_heads + di + di * d + 2 * d
            n += self.num_layers * per
            # ONE shared attention block reused every attn_every layers
            n += 2 * d * d          # concat([h, h0]) -> d projection
            n += attn_params() + mlp_params(f) + 2 * d
        else:
            per = attn_params() + 2 * d
            if self.is_moe:
                per += d * self.num_experts  # router
                expert = mlp_params(f)
                if active_only:
                    per += self.experts_per_token * expert
                else:
                    per += self.num_experts * expert
            else:
                per += mlp_params(f)
            n += self.num_layers * per
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        return self.param_count(active_only=True)

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        return (self.n_attn_layers * 2 * self.num_kv_heads * self.head_dim
                * bytes_per_el)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # import side-effect registration of all arch modules
    import repro_torch.configs  # noqa: F401

    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def reduced(cfg: ArchConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 256) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    heads = 4 if cfg.num_heads else 0
    kv = 0
    if cfg.num_heads:
        # preserve the GQA ratio qualitatively
        kv = max(1, heads * cfg.num_kv_heads // cfg.num_heads)
        if cfg.num_kv_heads == cfg.num_heads:
            kv = heads
    changes = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=(d_model // heads) if heads else 0,
        d_ff=(2 * d_model) if cfg.d_ff else 0,
        vocab_size=vocab,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        frontend_tokens=4 if cfg.frontend != "none" else 0,
    )
    if cfg.is_moe:
        changes.update(num_experts=4, experts_per_token=2)
    if cfg.family == "hybrid":
        changes.update(attn_every=2, num_layers=max(layers, 4))
    return replace(cfg, **changes)
