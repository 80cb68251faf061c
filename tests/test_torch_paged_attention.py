"""Port parity: paged chunk attention and cached-only paged decode
attention (the plain PyTorch versions) against the JAX package's Pallas
kernels in interpret mode and their jnp oracles.

Inputs are drawn with numpy from a seed and handed to both packages.
Block tables come from one permutation of the pool, so no two rows share
a page (a serving table never does).  Tolerances: float32 on both sides
with different summation orders, values of order 1 — 2e-5 absolute and
relative; the int8 cases dequantize identically (int8 * f32 scale) on both
sides, so they hold the same bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import (
    paged_attention_kernel,
    paged_chunk_attention_kernel,
)
from repro.kernels.paged_attention.ref import paged_attention_ref as jcached
from repro.kernels.paged_attention.ref import paged_chunk_attention_ref as jref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref,
    paged_chunk_attention_ref,
)

TOL = 2e-5


def make_case(seed, b, t, kv, g, hd, page, max_pages, *, cow=False,
              quant=False):
    rng = np.random.default_rng(seed)
    n_pages = b * max_pages + 4
    f = np.float32
    case = {
        "q": rng.standard_normal((b, t, kv, g, hd)).astype(f),
        "k_new": rng.standard_normal((b, t, kv, hd)).astype(f),
        "v_new": rng.standard_normal((b, t, kv, hd)).astype(f),
        "k_pages": rng.standard_normal((n_pages, page, kv, hd)).astype(f),
        "v_pages": rng.standard_normal((n_pages, page, kv, hd)).astype(f),
        "block_tables": rng.permutation(n_pages)[:b * max_pages]
        .reshape(b, max_pages).astype(np.int32),
        # ragged, and row 0 always empty: it attends only to its chunk
        "lengths": np.concatenate(
            [[0], rng.integers(1, max_pages * page + 1, b - 1)])
        .astype(np.int32),
        "page_map": np.arange(n_pages, dtype=np.int32),
    }
    if cow:
        # the last row's first two pages are pending CoW destinations whose
        # sources are the spare pages past the tables: attention must read
        # the sources
        dst = case["block_tables"][-1, :2]
        spare = np.setdiff1d(np.arange(n_pages), case["block_tables"])
        case["page_map"][dst] = spare[:2]
        case["lengths"][-1] = max_pages * page
    if quant:
        for name in ("k", "v"):
            fp = case[f"{name}_pages"]
            sc = (np.abs(fp).max(axis=(1, 3)) / 127.0 + 1e-8).astype(f)
            case[f"{name}_pages"] = np.round(
                fp / sc[:, None, :, None]).astype(np.int8)
            case[f"{name}_scales"] = sc
    return case


def run_port(case):
    return paged_chunk_attention_ref(
        **{k: torch.from_numpy(v) for k, v in case.items()}).numpy()


def run_jax(case, *, interpret):
    args = {k: jnp.asarray(v) for k, v in case.items()}
    if interpret:
        return np.asarray(paged_chunk_attention_kernel(**args,
                                                       interpret=True))
    return np.asarray(jax.jit(jref)(**args))


# t in {1, 4, 9}, g in {1, 2, 6}, hd in {32, 128}, page in {4, 16}: every
# (t, g) pair, with (hd, page) cycling so that every pair of values of any
# two axes occurs (a pairwise-covering sweep; each case compiles the
# oracle anew); kv = 2, b = 3
SWEEP = [(t, g) + ((32, 4), (32, 16), (128, 4), (128, 16))[i % 4]
         for i, (t, g) in enumerate((t, g) for t in (1, 4, 9)
                                    for g in (1, 2, 6))]


@pytest.mark.parametrize("t,g,hd,page", SWEEP, ids=str)
def test_matches_jnp_oracle(t, g, hd, page):
    case = make_case(1000 * t + 100 * g + hd + page, 3, t, 2, g, hd, page,
                     max_pages=3 if page == 16 else 6)
    np.testing.assert_allclose(run_port(case), run_jax(case, interpret=False),
                               rtol=TOL, atol=TOL)


# every value of every swept axis, through the interpreted Pallas kernel
INTERPRET = [(1, 1, 32, 4), (4, 2, 128, 16), (9, 6, 32, 16),
             (9, 1, 128, 4), (1, 6, 128, 16), (4, 2, 32, 4)]


@pytest.mark.parametrize("t,g,hd,page", INTERPRET, ids=str)
def test_matches_interpreted_kernel(t, g, hd, page):
    case = make_case(7, 3, t, 2, g, hd, page, max_pages=3)
    np.testing.assert_allclose(run_port(case), run_jax(case, interpret=True),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("interpret", [False, True], ids=["oracle", "kernel"])
def test_cow_redirect_and_int8(quant, interpret):
    case = make_case(11, 3, 4, 2, 2, 32, 4, max_pages=4, cow=True,
                     quant=quant)
    np.testing.assert_allclose(run_port(case),
                               run_jax(case, interpret=interpret),
                               rtol=TOL, atol=TOL)


def test_cow_redirect_reads_source_pages():
    """page_map on pre-copy pools == identity map on post-copy pools."""
    case = make_case(12, 2, 1, 2, 2, 32, 4, max_pages=4, cow=True)
    post = dict(case)
    redirected = np.nonzero(case["page_map"] != np.arange(
        len(case["page_map"])))[0]
    for name in ("k_pages", "v_pages"):
        post[name] = case[name].copy()
        post[name][redirected] = case[name][case["page_map"][redirected]]
    post["page_map"] = np.arange(len(case["page_map"]), dtype=np.int32)
    np.testing.assert_allclose(run_port(case), run_port(post),
                               rtol=TOL, atol=TOL)


def test_zero_length_row_attends_only_to_its_chunk():
    case = make_case(13, 3, 3, 1, 2, 32, 4, max_pages=3)
    out = run_port(case)
    assert np.isfinite(out).all()
    # row 0 has no cached keys; its first chunk token sees only itself
    np.testing.assert_allclose(out[0, 0, :, 0], case["v_new"][0, 0],
                               rtol=TOL, atol=TOL)


def test_bf16_keeps_dtype():
    case = make_case(14, 2, 2, 2, 2, 32, 4, max_pages=3)
    args = {k: torch.from_numpy(v) for k, v in case.items()}
    for name in ("q", "k_new", "v_new", "k_pages", "v_pages"):
        args[name] = args[name].to(torch.bfloat16)
    out = paged_chunk_attention_ref(**args)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    case = make_case(15, 2, 1, 2, 2, 32, 4, max_pages=3)
    before = ops.LAUNCHES[ops.NAME]
    out = ops.paged_chunk_attention(
        **{k: torch.from_numpy(v) for k, v in case.items()})
    np.testing.assert_array_equal(out.numpy(), run_port(case))
    assert ops.LAUNCHES[ops.NAME] == before


def test_wrapper_validation_rejects_what_the_kernel_cannot_take():
    case = {k: torch.from_numpy(v) for k, v in
            make_case(16, 2, 1, 2, 2, 32, 4, max_pages=3).items()}
    ops._check(**case, k_scales=None, v_scales=None)   # well formed
    bad_hd = dict(case, q=torch.zeros(2, 1, 2, 2, 48))
    with pytest.raises(ValueError, match="head_dim"):
        ops._check(**bad_hd, k_scales=None, v_scales=None)
    bad_len = dict(case, lengths=case["lengths"].long())
    with pytest.raises(ValueError, match="lengths"):
        ops._check(**bad_len, k_scales=None, v_scales=None)
    int8 = dict(case, k_pages=case["k_pages"].to(torch.int8),
                v_pages=case["v_pages"].to(torch.int8))
    with pytest.raises(ValueError, match="scales"):
        ops._check(**int8, k_scales=None, v_scales=None)
    strided = dict(case, k_new=case["k_new"].transpose(2, 3).contiguous()
                   .transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(**strided, k_scales=None, v_scales=None)


# ---------------------------------------------------------------------------
# cached-only decode attention (the legacy attn_impl="ref" step)
# ---------------------------------------------------------------------------

def cached_case(seed, b, kv, g, hd, page, max_pages, lengths=None):
    """Disjoint pages across rows (one permutation of the pool); ragged
    lengths from 1 to the full table unless given."""
    rng = np.random.default_rng(seed)
    n_pages = b * max_pages + 3
    f = np.float32
    if lengths is None:
        lengths = rng.integers(1, max_pages * page + 1, b)
    return {
        "q": rng.standard_normal((b, kv, g, hd)).astype(f),
        "k_pages": rng.standard_normal((n_pages, page, kv, hd)).astype(f),
        "v_pages": rng.standard_normal((n_pages, page, kv, hd)).astype(f),
        "block_tables": rng.permutation(n_pages)[:b * max_pages]
        .reshape(b, max_pages).astype(np.int32),
        "lengths": np.asarray(lengths, np.int32),
    }


def run_port_cached(case):
    return paged_attention_ref(
        **{k: torch.from_numpy(v) for k, v in case.items()}).numpy()


def run_jax_cached(case, *, interpret):
    args = [jnp.asarray(case[k]) for k in
            ("q", "k_pages", "v_pages", "block_tables", "lengths")]
    if interpret:
        return np.asarray(paged_attention_kernel(*args, interpret=True))
    return np.asarray(jax.jit(jcached)(*args))


# b, kv, g, hd, page, max_pages: the sweep of
# tests/kernels/test_paged_attention.py (f32), plus hd 32 (paper-agentic)
CACHED_SWEEP = [(1, 1, 1, 128, 8, 4), (2, 2, 4, 128, 16, 8),
                (3, 4, 2, 64, 8, 5), (2, 1, 8, 128, 8, 6),
                (3, 2, 2, 32, 4, 6)]


@pytest.mark.parametrize("interpret", [False, True], ids=["oracle", "kernel"])
@pytest.mark.parametrize("b,kv,g,hd,page,max_pages", CACHED_SWEEP, ids=str)
def test_cached_matches_jax(b, kv, g, hd, page, max_pages, interpret):
    case = cached_case(b * 100 + hd + page, b, kv, g, hd, page, max_pages)
    np.testing.assert_allclose(run_port_cached(case),
                               run_jax_cached(case, interpret=interpret),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("interpret", [False, True], ids=["oracle", "kernel"])
def test_cached_length_one_and_full_pool(interpret):
    """Length 1 attends to its one cached token (output = its v); a full
    table attends to every slot (tests/kernels/test_paged_attention.py
    :71 and :85)."""
    one = cached_case(21, 2, 2, 2, 64, 8, 4, lengths=[1, 1])
    out = run_port_cached(one)
    np.testing.assert_allclose(out, run_jax_cached(one, interpret=interpret),
                               rtol=TOL, atol=TOL)
    v0 = one["v_pages"][one["block_tables"][:, 0], 0]       # [b, kv, hd]
    np.testing.assert_allclose(out[:, :, 0], v0, rtol=TOL, atol=TOL)
    full = cached_case(22, 2, 1, 4, 128, 8, 8, lengths=[64, 64])
    np.testing.assert_allclose(run_port_cached(full),
                               run_jax_cached(full, interpret=interpret),
                               rtol=TOL, atol=TOL)


def test_cached_zero_length_row_is_zero():
    """The TPU kernel clamps the softmax sum and returns 0 for a row of
    length 0; the plain version gives 0 too, not NaN."""
    case = cached_case(23, 3, 2, 2, 32, 4, 3, lengths=[0, 5, 12])
    out = run_port_cached(case)
    assert np.isfinite(out).all() and not out[0].any()
    np.testing.assert_allclose(
        out, run_jax_cached(case, interpret=True), rtol=TOL, atol=TOL)


def test_cached_equals_chunk_attention_of_the_last_token():
    """Cached-only attention over lengths + 1 with the token in its slot is
    chunk attention (t = 1) over lengths with the token inline."""
    case = cached_case(24, 3, 2, 3, 32, 4, 4, lengths=[1, 7, 16])
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    rows = torch.arange(3)
    last = t["lengths"].long() - 1
    slot = t["block_tables"][rows, last // 4].long()
    k_tok = t["k_pages"][slot, last % 4]                  # [b, kv, hd]
    v_tok = t["v_pages"][slot, last % 4]
    chunk = paged_chunk_attention_ref(
        t["q"][:, None], k_tok[:, None], v_tok[:, None], t["k_pages"],
        t["v_pages"], t["block_tables"], t["lengths"] - 1)
    np.testing.assert_allclose(run_port_cached(case), chunk[:, 0].numpy(),
                               rtol=TOL, atol=TOL)


def test_cached_wrapper_on_cpu_and_its_validation():
    case = {k: torch.from_numpy(v) for k, v in
            cached_case(25, 2, 2, 2, 32, 4, 3).items()}
    before = ops.LAUNCHES[ops.CACHED_NAME]
    out = ops.paged_attention(**case)
    np.testing.assert_array_equal(out.numpy(),
                                  paged_attention_ref(**case).numpy())
    assert ops.LAUNCHES[ops.CACHED_NAME] == before
    ops._check_cached(**case)                              # well formed
    with pytest.raises(ValueError, match="head_dim"):
        ops._check_cached(**dict(case, q=torch.zeros(2, 2, 2, 48)))
    with pytest.raises(ValueError, match="lengths"):
        ops._check_cached(**dict(case, lengths=case["lengths"].long()))
    with pytest.raises(ValueError, match="k_pages"):
        ops._check_cached(**dict(case, k_pages=case["k_pages"].double()))
