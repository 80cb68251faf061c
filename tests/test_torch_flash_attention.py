"""Port parity: causal GQA flash attention (the plain PyTorch version)
against the JAX package's Pallas kernel in interpret mode (whose shapes
must be multiples of its 128-row blocks) and against the jnp
``chunked_causal_attention`` the JAX prefill uses, at ragged lengths.

Inputs are drawn with numpy from a seed.  Tolerance: float32 on both
sides with different summation orders over up to 256 keys — 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.models.layers import chunked_causal_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TOL = 2e-5


def make_qkv(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


def run_port(q, k, v):
    return flash_attention_ref(*map(torch.from_numpy, (q, k, v))).numpy()


@pytest.mark.parametrize("b,s,h,kv,hd", [
    (1, 128, 4, 2, 32),      # GQA, one block
    (2, 256, 6, 2, 64),      # g = 3, two blocks
    (1, 128, 2, 2, 128),     # MHA
    (1, 128, 2, 2, 112),     # zamba2-7b's shared block: MHA at hd 112
], ids=str)
def test_matches_interpreted_kernel(b, s, h, kv, hd):
    q, k, v = make_qkv(s + h + hd, b, s, h, kv, hd)
    want = flash_attention_kernel(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), interpret=True)
    np.testing.assert_allclose(run_port(q, k, v), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,h,kv,hd", [(1, 12, 2, 128), (13, 4, 1, 32),
                                       (200, 12, 2, 128), (77, 4, 4, 112)],
                         ids=str)
def test_matches_chunked_attention_at_ragged_lengths(s, h, kv, hd):
    q, k, v = make_qkv(s * 7 + hd, 2, s, h, kv, hd)
    want = jax.jit(chunked_causal_attention, static_argnames="chunk")(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=64)
    np.testing.assert_allclose(run_port(q, k, v), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_first_row_attends_only_to_itself():
    q, k, v = make_qkv(3, 1, 9, 4, 2, 32)
    out = run_port(q, k, v)
    np.testing.assert_allclose(out[0, 0], np.repeat(v[0, 0], 2, axis=0),
                               rtol=TOL, atol=TOL)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    q, k, v = map(torch.from_numpy, make_qkv(4, 1, 17, 4, 2, 32))
    before = ops.LAUNCHES[ops.NAME]
    out = ops.flash_attention(q, k, v)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v),
                               rtol=0, atol=0)
    assert ops.LAUNCHES[ops.NAME] == before


def test_bf16_keeps_dtype():
    q, k, v = (x.to(torch.bfloat16) for x in
               map(torch.from_numpy, make_qkv(5, 1, 33, 4, 2, 32)))
    out = flash_attention_ref(q, k, v)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
