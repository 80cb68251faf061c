"""The plain reference against the port's own forward pass on the CPU, in
float32, over each layer option the configurations use: q/k/v biases and a
tied head (granite-8b), SwiGLU and GeGLU, and dropless sparse experts
(dbrx-132b-stage8)."""

import pytest
import torch

from benchlib import files
from benchlib import weights as W

BASE = {"name": "tiny", "family": "dense", "num_layers": 2, "d_model": 64,
        "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
        "vocab_size": 97, "rope_theta": 500000.0, "norm_eps": 1e-5,
        "dtype": "float32"}
CASES = {
    "bias-tied-swiglu": dict(mlp_activation="swiglu", qkv_bias=True,
                             tie_embeddings=True),
    "untied-geglu": dict(mlp_activation="geglu", qkv_bias=False,
                         tie_embeddings=False),
    "experts-swiglu": dict(family="moe", mlp_activation="swiglu",
                           num_experts=8, experts_per_token=2,
                           moe_capacity_factor=4.0, qkv_bias=False,
                           tie_embeddings=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_reference_follows_the_port(case):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import forward, lm_head

    m = dict(BASE, **CASES[case])
    cfg = ArchConfig(**m)
    p = W.draw(Model(cfg).init(device="meta"), 7, "cpu")
    seq = torch.randint(0, m["vocab_size"], (40,),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        h, _ = forward(cfg, p, seq[None], remat=False)
        want = lm_head(cfg, p, h)[0]
    ref = files.reference_module({"reference": "decoder"})
    got = ref.score(m, p, [seq.tolist()], [0])[0]
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), \
        (got - want).abs().max()
    # the head is the one the configuration names
    if m["tie_embeddings"]:
        assert "lm_head" not in p
    if m["qkv_bias"]:
        assert float(p["layers"]["attn"]["bq"].abs().max()) > 0
