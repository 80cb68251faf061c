"""Parameters, embedding, output head, training forward and loss of the
port's families.

Counterparts of ``init_transformer``, ``embed_tokens``, ``lm_head``,
``forward`` and ``token_loss`` in ``repro/models/transformer.py``, for
every family the JAX package registers: dense, vlm (stub frontend), audio (several codebooks) and moe
(attention + the MoE FFN), ssm (Mamba2) and hybrid (a Mamba2 backbone and
ONE weight-shared attention + MLP block, ``shared``, applied every
``attn_every`` layers on ``concat([h, h0])``).  Parameters are a plain dict
of tensors in the JAX package's layout, layers stacked ``[L, ...]``.

**Over a mesh** (a training plan: ``plan_from_mesh``), one host process
runs the pass the JAX package leaves to XLA's partitioner, one data
position at a time (:func:`position_forward`, :func:`position_nll`;
``Model.loss`` combines the positions).  The batch splits over the data
positions (``batch_spec``: contiguous rows, position ``d`` on
``plan.grid[d][0]``).  Inside each data position every sublayer runs
shard-locally over the model positions (:mod:`models.sharded`: attention
and FFN, the Mamba2 block over its heads, the hybrid's shared block) and
the partials are summed in shard order.  Each layer (each hybrid group)
takes its part of the parameters at use, inside its remat'd body
(:func:`distributed.sharding.position_params`: the pieces of the stored
blocks gathered onto the position's card), so the backward's recompute
gathers it again and a card holds at most a layer or two gathered beside
its blocks; the embedding, the image projection, ``final_norm`` and the
head are gathered where they are used.  The loss combines the positions'
token sums and counts (:func:`position_nll`), so it is the single-device
loss whatever the mask; the MoE aux loss is the mean over the data
positions (the GShard convention of the JAX package).  Every family
splits over both axes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.blocked import take
from repro_torch.distributed.collectives import broadcast
from repro_torch.distributed.mesh import ParallelPlan
from repro_torch.distributed.sharding import (
    WHOLE,
    Placement,
    position_params,
)
from repro_torch.models import layers as L
from repro_torch.models import sharded
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.models.ssm import init_mamba, mamba_block

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: the families whose layers are attention + an FFN (the MLP, or the MoE
#: block of an MoE config)
ATTN_FAMILIES = ("dense", "vlm", "audio", "moe")
#: the families whose layers are Mamba2 blocks (the hybrid adds its shared
#: attention block)
SSM_FAMILIES = ("ssm", "hybrid")
MLP_ACTIVATIONS = ("swiglu", "geglu", "sqrelu")
#: of the attention families, those the paged ServeEngine serves (the VLM
#: stub's text path; several codebooks are refused)
ENGINE_FAMILIES = ("dense", "vlm", "moe")


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def check_servable(cfg: ArchConfig) -> None:
    """The port serves every family the JAX package registers: dense,
    VLM-stub, audio (several codebooks) and MoE with any of the three
    MLPs; the attention-free SSM (Mamba2) family; and the hybrid (Mamba2
    layers and a shared attention block every ``attn_every`` of them).
    The Mamba2 blocks take one B/C group."""
    if cfg.family in SSM_FAMILIES:
        ok = cfg.ssm_groups == 1 and (cfg.family == "ssm" or (
            cfg.attn_every > 0 and cfg.mlp_activation in MLP_ACTIVATIONS))
    else:
        ok = (cfg.family in ATTN_FAMILIES
              and cfg.mlp_activation in MLP_ACTIVATIONS
              and (cfg.family == "moe") == cfg.is_moe)
    if not ok:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}, {cfg.mlp_activation}): the port "
            f"serves the {'/'.join(ATTN_FAMILIES)} families with "
            f"{'/'.join(MLP_ACTIVATIONS)} MLPs (experts only in moe), and "
            "the SSM and hybrid families with one B/C group")


def check_engine_servable(cfg: ArchConfig) -> None:
    """The paged engine serves the dense and MoE families and the VLM
    stub's text path; several codebooks (audio), the SSM and hybrid
    families and whatever :func:`check_servable` refuses are refused."""
    check_servable(cfg)
    if cfg.num_codebooks > 1:
        raise NotImplementedError(
            f"{cfg.name}: the paged engine serves one token per row; "
            f"{cfg.num_codebooks} codebooks run through Model.prefill / "
            "Model.decode_step over a contiguous cache (the JAX package's "
            "engine fails on them too)")
    if cfg.family not in ENGINE_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the paged engine serves the "
            f"{'/'.join(ENGINE_FAMILIES)} (text) families; the SSM and "
            "hybrid families run through Model.prefill / decode_step and "
            "BranchStore (the JAX package's engine refuses them too)")


def init_transformer(cfg: ArchConfig, gen: torch.Generator,
                     place: Placement = WHOLE) -> Any:
    """Random weights drawn from ``gen`` on its device.  Each stacked
    ``[L, ...]`` leaf is allocated once and filled layer by layer, so the
    peak is the model plus one layer and one f32 draw.  ``place`` puts each
    leaf as it is drawn: whole where drawn (:data:`~repro_torch.
    distributed.sharding.WHOLE`), or cut into a serving plan's tp shards
    (:class:`~repro_torch.distributed.sharding.ShardDraw`: one tree per
    shard, the drawing device holding its own shard plus one layer and one
    f32 draw)."""
    check_servable(cfg)
    dtype = torch_dtype(cfg)
    dev = gen.device
    d, n, cb = cfg.d_model, cfg.num_layers, cfg.num_codebooks

    def keep(path: Tuple[str, ...], x: Any) -> Any:
        if isinstance(x, dict):
            return {k: keep(path + (k,), v) for k, v in x.items()}
        return place.leaf(path, x)

    embed_shape = (cb, cfg.vocab_size, d) if cb > 1 else (cfg.vocab_size, d)
    p: Params = {"embed": keep(("embed",), L.dense_init(
        gen, embed_shape, dtype, fan_in=d))}
    if cfg.frontend == "vlm_stub":
        p["frontend_proj"] = keep(("frontend_proj",),
                                  L.dense_init(gen, (d, d), dtype))
    if cfg.family in SSM_FAMILIES:
        def one() -> Params:
            return {"ln": torch.ones((d,), dtype=dtype, device=dev),
                    "mamba": init_mamba(cfg, gen, dtype)}
    else:
        def one() -> Params:
            lp = {"ln1": torch.ones((d,), dtype=dtype, device=dev),
                  "ln2": torch.ones((d,), dtype=dtype, device=dev),
                  "attn": L.init_attention(cfg, gen, dtype)}
            if cfg.is_moe:
                lp["moe"] = init_moe(cfg, gen, dtype)   # router in f32
            else:
                lp["mlp"] = L.init_mlp(cfg, gen, dtype)
            return lp
    p["layers"] = _stacked(n, one, place)
    if cfg.family == "hybrid":
        # ONE attention + MLP block, its weights shared by every application
        p["shared"] = keep(("shared",), {
            "w_concat": L.dense_init(gen, (2 * d, d), dtype),
            "ln1": torch.ones((d,), dtype=dtype, device=dev),
            "ln2": torch.ones((d,), dtype=dtype, device=dev),
            "attn": L.init_attention(cfg, gen, dtype),
            "mlp": L.init_mlp(cfg, gen, dtype),
        })
    p["final_norm"] = keep(("final_norm",),
                           torch.ones((d,), dtype=dtype, device=dev))
    if not cfg.tie_embeddings:
        p["lm_head"] = keep(("lm_head",), L.dense_init(
            gen, (d, cb * cfg.vocab_size), dtype, fan_in=d))
    return place.trees(p)


def _stacked(n: int, one: Callable[[], Params],
             place: Placement = WHOLE) -> Params:
    """``n`` draws of the layer tree ``one()`` stacked ``[n, ...]``: every
    leaf is allocated once (where ``place`` puts it), and each layer's
    draw is copied into its slot and dropped before the next is drawn."""
    first = one()

    def alloc(x: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(x, dict):
            return {k: alloc(v, path + (k,)) for k, v in x.items()}
        return place.alloc(path, x, n)

    def fill(dst: Any, i: int, src: Any, path: Tuple[str, ...]) -> None:
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], i, src[k], path + (k,))
        else:
            place.fill(path, dst, i, src)

    out = alloc(first, ("layers",))
    fill(out, 0, first, ("layers",))
    del first
    for i in range(1, n):
        fill(out, i, one(), ("layers",))
    return out


def embed_tokens(cfg: ArchConfig, p: Params, tokens: torch.Tensor,
                 frontend_embed: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """tokens ``[b, s]`` (``[b, s, cb]`` for several codebooks) -> hidden
    ``[b, s, d]``.  Codebook embeddings are summed in order in the model's
    type, as the JAX package does.  For the VLM stub, ``frontend_embed``
    ``[b, n, d]`` (precomputed patch embeddings) is projected by
    ``frontend_proj`` and replaces positions ``[0, n)``."""
    if cfg.num_codebooks > 1:
        h = p["embed"][0][tokens[..., 0]]
        for i in range(1, cfg.num_codebooks):
            h = h + p["embed"][i][tokens[..., i]]
    else:
        h = p["embed"][tokens]
    if cfg.frontend == "vlm_stub" and frontend_embed is not None:
        n = frontend_embed.shape[1]
        if n > h.shape[1]:
            raise ValueError(f"frontend_embed covers {n} positions of a "
                             f"{h.shape[1]}-token sequence")
        fe = frontend_embed.to(h.dtype) @ p["frontend_proj"]
        h = torch.cat([fe, h[:, n:]], dim=1)
    return h


def lm_head(cfg: ArchConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    """h: ``[b, s, d]`` -> logits ``[b, s, V]``, or ``[b, s, cb, V]``
    codebook-major (column ``c * V + v``) for several codebooks."""
    if cfg.tie_embeddings:
        logits = h @ p["embed"].T
    else:
        logits = h @ p["lm_head"]
    if cfg.num_codebooks > 1:
        logits = logits.unflatten(-1, (cfg.num_codebooks, cfg.vocab_size))
    return logits


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------

def _attn_mlp_layer(cfg: ArchConfig, lp: Params, h: torch.Tensor,
                    positions: torch.Tensor, attn_chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention + FFN layer; returns (h, the MoE aux loss or 0)."""
    h = h + L.attention_block(cfg, lp["attn"],
                              L.rms_norm(h, lp["ln1"], cfg.norm_eps),
                              positions, attn_chunk)
    x = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        m, aux = moe_block(cfg, lp["moe"], x)
    else:
        m, aux = L.mlp_block(cfg, lp["mlp"], x), h.new_zeros((),
                                                             dtype=torch.float32)
    return h + m, aux


def _mamba_layer(cfg: ArchConfig, lp: Params, h: torch.Tensor
                 ) -> torch.Tensor:
    return h + mamba_block(cfg, lp["mamba"],
                           L.rms_norm(h, lp["ln"], cfg.norm_eps))


def _shared_attn_block(cfg: ArchConfig, sp: Params, h: torch.Tensor,
                       h0: torch.Tensor, positions: torch.Tensor,
                       attn_chunk: int) -> torch.Tensor:
    """The hybrid's shared block on ``concat([h, h0]) @ w_concat``."""
    x = torch.cat([h, h0], dim=-1) @ sp["w_concat"]
    x = x + L.attention_block(cfg, sp["attn"],
                              L.rms_norm(x, sp["ln1"], cfg.norm_eps),
                              positions, attn_chunk)
    m = L.mlp_block(cfg, sp["mlp"], L.rms_norm(x, sp["ln2"], cfg.norm_eps))
    return h + x + m


def forward(cfg: ArchConfig, p: Params, tokens: torch.Tensor,
            frontend_embed: Optional[torch.Tensor] = None, *,
            remat: bool = True, attn_chunk: int = 1024
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (final-normed hidden ``[b, s, d]``, the MoE
    aux loss summed over layers, f32).

    With ``remat`` each layer is recomputed in the backward instead of
    keeping its activations (:func:`layers.remat`, ``jax.checkpoint`` in
    the JAX package): for the hybrid each group of ``attn_every`` Mamba2
    layers with the shared block after it, and not the ``num_layers %
    attn_every`` tail layers, as there.  The attention and Mamba2 blocks
    therefore launch their kernels twice per step with remat (forward and
    recompute), once without.
    """
    check_servable(cfg)
    h = embed_tokens(cfg, p, tokens, frontend_embed)
    positions = torch.arange(h.shape[1], device=h.device)
    aux = h.new_zeros((), dtype=torch.float32)
    wrap = L.remat if remat else (lambda fn, *args: fn(*args))
    n = cfg.num_layers
    layers = L.unstack_layers(p["layers"], n)
    if cfg.family in ATTN_FAMILIES:
        for lp in layers:
            h, a = wrap(lambda h_, lp_: _attn_mlp_layer(
                cfg, lp_, h_, positions, attn_chunk), h, lp)
            aux = aux + a
    elif cfg.family == "ssm":
        for lp in layers:
            h = wrap(lambda h_, lp_: _mamba_layer(cfg, lp_, h_), h, lp)
    else:                                               # hybrid
        h0, k = h, cfg.attn_every
        n_groups = n // k

        def group(h_: torch.Tensor, glp: list) -> torch.Tensor:
            for lp in glp:
                h_ = _mamba_layer(cfg, lp, h_)
            return _shared_attn_block(cfg, p["shared"], h_, h0, positions,
                                      attn_chunk)

        for g in range(n_groups):
            h = wrap(group, h, layers[g * k:(g + 1) * k])
        for lp in layers[n_groups * k:]:
            h = _mamba_layer(cfg, lp, h)
    return L.rms_norm(h, p["final_norm"], cfg.norm_eps), aux


def position_rows(plan: ParallelPlan, *xs: Optional[torch.Tensor]
                  ) -> List[List[Optional[torch.Tensor]]]:
    """Each data position's rows of the batch-major ``xs`` (``batch_spec``:
    contiguous, in position order), on the position's first device."""
    n = plan.dp_size
    b = next(x for x in xs if x is not None).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split over {n} data "
                         "positions")
    rows = b // n
    return [[None if x is None else x[d * rows:(d + 1) * rows].to(
        plan.grid[d][0]) for x in xs] for d in range(n)]


def position_forward(cfg: ArchConfig, p: Params, plan: ParallelPlan, d: int,
                     tokens: torch.Tensor,
                     frontend_embed: Optional[torch.Tensor] = None, *,
                     remat: bool = True, attn_chunk: int = 1024
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Data position ``d``'s forward over its rows (on ``plan.grid[d][0]``)
    from the parameters ``p`` (tensors, or stored blocks): each layer's
    part of the parameters gathered at use inside the layer's remat'd body
    (the hybrid: inside each group's), then the single-device layer at one
    tp rank or the shard-local passes (:mod:`models.sharded`) with the
    residual on rank 0, remat as :func:`forward`."""
    row = plan.grid[d]
    tp, home = len(row), row[0]

    def at(tree: Params, path: Tuple[str, ...] = ()) -> List[Params]:
        return [position_params(cfg, tree, r, tp, dev, path)
                for r, dev in enumerate(row)]

    h = embed_tokens(cfg, {k: take(p[k], home) for k in
                           ("embed", "frontend_proj") if k in p},
                     tokens, frontend_embed)
    positions = broadcast(torch.arange(h.shape[1], device=home), row)
    aux = h.new_zeros((), dtype=torch.float32)
    wrap = L.remat if remat else (lambda fn, *args: fn(*args))
    n = cfg.num_layers
    layers = L.unstack_layers(p["layers"], n)

    def mamba_layer(h_: torch.Tensor, lv: Params) -> torch.Tensor:
        lps = at(lv)
        if tp == 1:
            return _mamba_layer(cfg, lps[0], h_)
        return sharded.mamba_layer(cfg, lps, h_)

    if cfg.family in ATTN_FAMILIES:
        def attn_layer(h_: torch.Tensor, lv: Params):
            lps = at(lv)
            if tp == 1:
                return _attn_mlp_layer(cfg, lps[0], h_, positions[0],
                                       attn_chunk)
            return sharded.layer(cfg, lps, h_, positions, attn_chunk)

        for lv in layers:
            h, a = wrap(attn_layer, h, lv)
            aux = aux + a
    elif cfg.family == "ssm":
        for lv in layers:
            h = wrap(mamba_layer, h, lv)
    else:                                               # hybrid
        h0, k = h, cfg.attn_every
        n_groups = n // k
        shared = {key: v for key, v in p["shared"].items()
                  if key != "w_concat"}

        def group(h_: torch.Tensor, glv: list) -> torch.Tensor:
            for lv in glv:
                h_ = mamba_layer(h_, lv)
            sps = at(shared, ("shared",))
            w = take(p["shared"]["w_concat"], home)
            if tp == 1:
                return _shared_attn_block(cfg, {**sps[0], "w_concat": w},
                                          h_, h0, positions[0], attn_chunk)
            return sharded.shared_block(cfg, sps, w, h_, h0, positions,
                                        attn_chunk)

        for g in range(n_groups):
            h = wrap(group, h, layers[g * k:(g + 1) * k])
        for lv in layers[n_groups * k:]:
            h = mamba_layer(h, lv)
    return L.rms_norm(h, take(p["final_norm"], home), cfg.norm_eps), aux


# ---------------------------------------------------------------------------
# loss (sequence-chunked cross-entropy: the f32 logits of one chunk at a
# time)
# ---------------------------------------------------------------------------

def _chunk_nll(cfg: ArchConfig, head: Callable[[torch.Tensor], torch.Tensor],
               h_c: torch.Tensor, t_c: torch.Tensor, v_c: torch.Tensor
               ) -> torch.Tensor:
    """The summed next-token NLL of one chunk under the output ``head``
    (``v_c`` masks positions; several codebooks averaged)."""
    logits = head(h_c).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t_c[..., None].long())[..., 0]
    nll = logz - gold                                   # [b, c] or [b, c, cb]
    if cfg.num_codebooks > 1:
        nll = nll.mean(-1)
    return torch.sum(nll * v_c)


def loss_mask(cfg: ArchConfig, s: int, device: Any) -> torch.Tensor:
    """``[s]`` f32: 1 where a position carries loss (the VLM stub's
    image-prefix positions carry none)."""
    if cfg.frontend == "vlm_stub":
        return (torch.arange(s, device=device) >= cfg.frontend_tokens).float()
    return torch.ones(s, dtype=torch.float32, device=device)


def token_nll(cfg: ArchConfig, head: Callable[[torch.Tensor], torch.Tensor],
              h: torch.Tensor, targets: torch.Tensor, *,
              loss_chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed next-token cross-entropy, the count of positions carrying
    loss), f32 scalars, of h ``[b, s, d]`` against targets ``[b, s]``
    (``[b, s, cb]``), ``loss_chunk`` positions at a time, each chunk's f32
    logits recomputed in the backward (:func:`layers.remat`) so the logits
    of all chunks never live at once."""
    b, s, _ = h.shape
    loss_chunk = min(loss_chunk, s)
    if s % loss_chunk:
        raise ValueError(f"loss_chunk {loss_chunk} does not divide the "
                         f"sequence length {s}")
    valid = loss_mask(cfg, s, h.device)
    total = h.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, loss_chunk):
        sl = slice(c0, c0 + loss_chunk)
        total = total + L.remat(
            lambda h_c, t_c, v_c: _chunk_nll(cfg, head, h_c, t_c, v_c),
            h[:, sl], targets[:, sl], valid[sl])
    return total, valid.sum() * b


def position_nll(cfg: ArchConfig, p: Params, plan: ParallelPlan, d: int,
                 h: torch.Tensor, targets: torch.Tensor, *,
                 loss_chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`token_nll` of data position ``d`` over its tp ranks, the head
    gathered at use: an untied head's vocab columns split over the ranks
    and gathered (:func:`sharded.gathered_logits`), a tied head whole on
    rank 0."""
    return token_nll(cfg, position_head(cfg, p, plan, d), h, targets,
                     loss_chunk=loss_chunk)


def position_head(cfg: ArchConfig, p: Params, plan: ParallelPlan, d: int
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Data position ``d``'s output head, gathered at use: an untied
    head's vocab columns split over its tp ranks and the logits gathered
    (:func:`sharded.gathered_logits`), a tied head whole on rank 0."""
    row = plan.grid[d]
    key = "embed" if cfg.tie_embeddings else "lm_head"
    if len(row) == 1 or cfg.tie_embeddings:
        hp = {key: take(p[key], row[0])}
        return lambda x: lm_head(cfg, hp, x)
    trees = [position_params(cfg, {key: p[key]}, r, len(row), dev)
             for r, dev in enumerate(row)]
    return lambda x: sharded.gathered_logits(cfg, trees, x)


def token_loss(cfg: ArchConfig, p: Params, h: torch.Tensor,
               targets: torch.Tensor, *, loss_chunk: int = 512
               ) -> torch.Tensor:
    """Mean next-token cross-entropy of h ``[b, s, d]`` against targets
    (:func:`token_nll`)."""
    total, count = token_nll(cfg, lambda x: lm_head(cfg, p, x), h, targets,
                             loss_chunk=loss_chunk)
    return total / torch.clamp(count, min=1.0)
