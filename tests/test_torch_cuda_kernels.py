"""The port's CUDA kernels on the card (skipped without one).

A CUDA kernel has no CPU mode, so these tests run only on a machine with
a card: ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
Each kernel is held against its plain PyTorch version on the same inputs,
and the float32 engine on the card must decode the same greedy tokens as
on the CPU.  Both versions compute in float32 from the same inputs and
round once to the output's type, so float32 outputs differ by summation
order only (2e-5) and bfloat16 outputs by at most one ulp of the value
(2**-7 of it) plus that order noise.  The bf16 kernels of flash attention,
the SSD scan and the paged walk run their products on the tensor cores
with each f32 operand split into bf16 terms
(tests/test_torch_tc_numerics.py), and are held to the same tolerance.
"""

import dataclasses
import json
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import BranchStore
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref,
    paged_chunk_attention_ref,
)
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import Model
from repro_torch.runtime import ServeEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=0),
       torch.bfloat16: dict(atol=2e-5, rtol=2 ** -7)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def paged_case(gen, b, t, kv, g, hd, page, lengths, dtype, quant):
    max_pages = -(-max(lengths) // page)
    n_pages = b * max_pages + 1
    rand = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa
    case = dict(
        q=rand(b, t, kv, g, hd).to(dtype), k_new=rand(b, t, kv, hd).to(dtype),
        v_new=rand(b, t, kv, hd).to(dtype),
        block_tables=torch.randperm(n_pages - 1, generator=gen,
                                    device="cuda").int().reshape(b, -1),
        lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"),
        page_map=torch.arange(n_pages, dtype=torch.int32, device="cuda"))
    case["page_map"][case["block_tables"][-1, 0]] = n_pages - 1   # CoW
    kp, vp = rand(n_pages, page, kv, hd), rand(n_pages, page, kv, hd)
    if quant:
        for name, fp in (("k", kp), ("v", vp)):
            sc = fp.abs().amax(dim=(1, 3)) / 127.0 + 1e-8
            case[f"{name}_pages"] = torch.round(
                fp / sc[:, None, :, None]).to(torch.int8)
            case[f"{name}_scales"] = sc
    else:
        case["k_pages"], case["v_pages"] = kp.to(dtype), vp.to(dtype)
    return case


@pytest.mark.parametrize("dtype,quant", [(torch.float32, False),
                                         (torch.bfloat16, False),
                                         (torch.bfloat16, True)],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd,g,t", [(32, 2, 1), (64, 1, 9), (128, 6, 40),
                                    (160, 4, 1), (160, 4, 9), (128, 16, 1),
                                    (128, 16, 4)], ids=str)
def test_paged_chunk_attention_kernel(gen, hd, g, t, dtype, quant):
    case = paged_case(gen, 3, t, 2, g, hd, 16, [0, 70, 33], dtype, quant)
    # bf16: one cluster launch; f32: the walk, and the combine when split
    tc = dtype == torch.bfloat16
    split = not tc and paged_ops.n_splits(3, t, 2, g, torch.device("cuda"),
                                          False) > 1
    before = paged_ops.LAUNCHES[paged_ops.NAME]
    out = paged_ops.paged_chunk_attention(**case)
    torch.cuda.synchronize()
    assert paged_ops.LAUNCHES[paged_ops.NAME] == before + 1 + split
    torch.testing.assert_close(out.float(),
                               paged_chunk_attention_ref(**case).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("t", [1, 4, 255])
@pytest.mark.parametrize("hd,g", [(32, 2), (64, 1), (128, 6), (160, 4),
                                  (128, 16)], ids=str)
def test_paged_chunk_attention_tensor_cores(gen, hd, g, t, quant):
    # the bf16 walk (one-warp blocks up to 32 rows, 64-row tiles above),
    # bf16 and int8 pools, a CoW redirect and a zero-length row: one launch
    case = paged_case(gen, 3, t, 2, g, hd, 16, [0, 700, 33], torch.bfloat16,
                      quant)
    before = paged_ops.LAUNCHES[paged_ops.NAME]
    out = paged_ops.paged_chunk_attention(**case)
    torch.cuda.synchronize()
    assert paged_ops.LAUNCHES[paged_ops.NAME] == before + 1
    torch.testing.assert_close(out.float(),
                               paged_chunk_attention_ref(**case).float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("hd,g", [(32, 2), (128, 6)], ids=str)
def test_paged_chunk_attention_at_page_8(gen, hd, g, t, dtype):
    # page 8 (the serving CLI's): a bf16 16-key tile spans two pages, and
    # t=8 at g=6 is speculative_decode's verify (48 rows: 64-row blocks);
    # rows of one page, a partial tail, a CoW redirect and zero length
    case = paged_case(gen, 4, t, 2, g, hd, 8, [0, 701, 8, 37], dtype, False)
    tc = dtype == torch.bfloat16
    split = not tc and paged_ops.n_splits(4, t, 2, g, torch.device("cuda"),
                                          False) > 1
    before = paged_ops.LAUNCHES[paged_ops.NAME]
    out = paged_ops.paged_chunk_attention(**case)
    torch.cuda.synchronize()
    assert paged_ops.LAUNCHES[paged_ops.NAME] == before + 1 + split
    torch.testing.assert_close(out.float(),
                               paged_chunk_attention_ref(**case).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 4, 37])
@pytest.mark.parametrize("hd,g", [(32, 2), (128, 6)], ids=str)
def test_paged_chunk_attention_at_page_4(gen, hd, g, t, dtype):
    # page 4 (the front door's parity geometry): a bf16 16-key tile spans
    # four pages; decode, a verify of 4 and a 37-token suffix prefill over
    # rows of one page, a partial tail, a CoW redirect and zero length
    case = paged_case(gen, 4, t, 2, g, hd, 4, [0, 701, 4, 37], dtype, False)
    tc = dtype == torch.bfloat16
    split = not tc and paged_ops.n_splits(4, t, 2, g, torch.device("cuda"),
                                          False) > 1
    before = paged_ops.LAUNCHES[paged_ops.NAME]
    out = paged_ops.paged_chunk_attention(**case)
    torch.cuda.synchronize()
    assert paged_ops.LAUNCHES[paged_ops.NAME] == before + 1 + split
    torch.testing.assert_close(out.float(),
                               paged_chunk_attention_ref(**case).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("splits", [1, 3, 9, 16])
def test_paged_chunk_attention_split_walk(gen, monkeypatch, splits):
    # the decode step's shape: 32 rows of uneven lengths, so split ranges
    # end mid-page, a range can be empty, and the cluster merges them
    monkeypatch.setattr(paged_ops, "n_splits", lambda *args: splits)
    lengths = torch.randint(0, 1100, (32,), generator=gen,
                            device="cuda").tolist()
    lengths[:3] = [0, 1, 16]
    case = paged_case(gen, 32, 1, 2, 6, 128, 16, lengths, torch.bfloat16,
                      False)
    out = paged_ops.paged_chunk_attention(**case)
    torch.testing.assert_close(out.float(),
                               paged_chunk_attention_ref(**case).float(),
                               **TOL[torch.bfloat16])


def test_paged_walk_one_page_under_the_widest_cluster(gen, monkeypatch):
    # rows of one page (and less) split over 16 blocks: most blocks of each
    # cluster have no key, and must still meet the cluster's barriers
    monkeypatch.setattr(paged_ops, "n_splits", lambda *args: 16)
    case = paged_case(gen, 4, 1, 2, 6, 128, 16, [16, 5, 1, 0],
                      torch.bfloat16, False)
    out = paged_ops.paged_chunk_attention(**case)
    torch.testing.assert_close(out.float(),
                               paged_chunk_attention_ref(**case).float(),
                               **TOL[torch.bfloat16])
    args = dict(q=case["q"][:, 0].contiguous(), k_pages=case["k_pages"],
                v_pages=case["v_pages"], block_tables=case["block_tables"],
                lengths=case["lengths"])
    out = paged_ops.paged_attention(**args)
    assert not out[3].any()
    torch.testing.assert_close(out.float(),
                               paged_attention_ref(**args).float(),
                               **TOL[torch.bfloat16])


def test_paged_walk_refuses_a_split_above_the_cluster_limit(gen,
                                                            monkeypatch):
    monkeypatch.setattr(paged_ops, "n_splits",
                        lambda *args: paged_ops.MAX_SPLITS + 1)
    case = paged_case(gen, 2, 1, 2, 6, 128, 16, [40, 5], torch.bfloat16,
                      False)
    with pytest.raises(ValueError, match="splits"):
        paged_ops.paged_chunk_attention(**case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s,h,kv,hd", [(1, 4, 2, 32), (77, 6, 2, 64),
                                       (300, 12, 2, 128), (77, 4, 4, 64),
                                       (300, 8, 2, 160), (77, 4, 4, 112),
                                       (300, 6, 2, 112)], ids=str)
def test_flash_attention_kernel(gen, s, h, kv, hd, dtype):
    q = torch.randn(2, s, h, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(2, s, kv, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(2, s, kv, hd, generator=gen, device="cuda").to(dtype)
    before = flash_ops.LAUNCHES[flash_ops.NAME]
    out = flash_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES[flash_ops.NAME] == before + 1
    torch.testing.assert_close(out.float(),
                               flash_attention_ref(q, k, v).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("s", [1023, 2048, 1025],
                         ids=["s1023", "s2048", "ragged1025"])
def test_flash_attention_tensor_cores_at_the_prefill_shape(gen, s):
    # the bf16 kernel (wgmma, P split in bf16 terms) at qwen2-1.5b's prefill
    # widths; 1025 leaves one row in the last 64-row tile
    q = torch.randn(1, s, 12, 128, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, s, 2, 128, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, s, 2, 128, generator=gen, device="cuda").bfloat16()
    out = flash_ops.flash_attention(q, k, v)
    torch.testing.assert_close(out.float(),
                               flash_attention_ref(q, k, v).float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("s,h,kv,hd", [(1023, 32, 8, 160), (2048, 32, 8, 160),
                                       (1025, 24, 24, 64), (1023, 32, 32, 112),
                                       (2048, 32, 32, 112), (1023, 64, 4, 128),
                                       (1023, 48, 8, 128)], ids=str)
def test_flash_attention_tensor_cores_at_the_families_shapes(gen, s, h, kv,
                                                             hd):
    # stablelm-12b's prefill (hd 160: five 32-column panels, 64-byte
    # swizzle), musicgen-medium's (MHA, g 1), zamba2-7b's shared block (hd
    # 112, staged as 128 with zero columns), qwen3-moe-235b-a22b's (g 16)
    # and dbrx-132b's (g 6), bf16 on wgmma
    q = torch.randn(1, s, h, hd, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, s, kv, hd, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, s, kv, hd, generator=gen, device="cuda").bfloat16()
    before = flash_ops.LAUNCHES[flash_ops.NAME]
    out = flash_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES[flash_ops.NAME] == before + 1
    torch.testing.assert_close(out.float(),
                               flash_attention_ref(q, k, v).float(),
                               **TOL[torch.bfloat16])


def test_wrappers_raise_instead_of_falling_back(gen):
    q = torch.randn(1, 8, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(q, q[:, :, :1].contiguous(),
                                  q[:, :, :1].contiguous())
    q = torch.randn(1, 2, 8, 32, device="cuda").transpose(1, 2)
    assert q.shape == (1, 8, 2, 32) and not q.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(q, q, q)


def test_engine_on_the_card_matches_the_cpu(gen):
    cfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(model, params, num_pages=64, page_size=4,
                          max_pages_per_seq=16, device=dev)
        sid = eng.add_request([5, 17, 3, 42, 7, 11, 2, 9, 30, 4, 8, 1, 22])
        toks = eng.decode([sid])
        kids = eng.fork(sid, 3)
        toks += eng.decode(kids) + eng.decode(kids)
        toks += eng.spec_verify(kids[0], [[1, 2, 3]])[0]
        out[dev] = toks
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("attn_impl", ["auto", "ref"])
def test_hd160_engine_on_the_card_matches_the_cpu(gen, attn_impl):
    """stablelm-12b's head dim through the engine: K2's prefill, K1's
    fused step or K3's legacy one, float32, card against CPU."""
    cfg = dataclasses.replace(get_config("paper-agentic"), d_model=640,
                              num_heads=4, num_kv_heads=2, head_dim=160,
                              num_layers=2, dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(model, params, num_pages=64, page_size=4,
                          max_pages_per_seq=16, device=dev,
                          attn_impl=attn_impl if dev == "cuda" else "auto")
        sid = eng.add_request([5, 17, 3, 42, 7, 11, 2, 9, 30, 4, 8, 1, 22])
        toks = eng.decode([sid])
        kids = eng.fork(sid, 3)
        toks += eng.decode(kids) + eng.decode(kids)
        toks += eng.spec_verify(kids[0], [[1, 2, 3]])[0]
        out[dev] = toks
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("name", ["musicgen-medium", "pixtral-12b"])
def test_contiguous_decode_on_the_card_matches_the_cpu(gen, name):
    """Model.prefill (K2; pixtral with a frontend_embed prefix) and greedy
    decode_steps over the contiguous cache, float32, card against CPU."""
    cfg = dataclasses.replace(reduced(get_config(name), d_model=128),
                              dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    cb = cfg.num_codebooks
    tokens = rng.integers(0, cfg.vocab_size, (2, 30, cb) if cb > 1
                          else (2, 30))
    fe = rng.standard_normal((2, 8, cfg.d_model), np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        logits, cache = model.prefill(
            p, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(fe).to(dev) if cfg.frontend == "vlm_stub"
            else None, max_len=36)
        toks = []
        for i in range(6):
            tok = logits[:, -1].argmax(-1)
            toks.append(tok.tolist())
            logits, cache = model.decode_step(
                p, cache, tok[:, None], torch.full((2,), 30 + i, device=dev))
        out[dev] = toks
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,g", [(32, 2), (128, 6), (160, 4)], ids=str)
def test_paged_attention_kernel(gen, hd, g, dtype):
    # cached-only decode: ragged lengths, a zero-length row (zeros, not
    # NaN), a full last page; split or not as the wrapper decides
    lengths = [0, 1, 16, 700, 1055, 333]
    case = paged_case(gen, 6, 1, 2, g, hd, 16, lengths, dtype, False)
    args = dict(q=case["q"][:, 0].contiguous(), k_pages=case["k_pages"],
                v_pages=case["v_pages"], block_tables=case["block_tables"],
                lengths=case["lengths"])
    split = dtype == torch.float32 and paged_ops.n_splits(
        6, 1, 2, g, torch.device("cuda"), False) > 1
    before = paged_ops.LAUNCHES[paged_ops.CACHED_NAME]
    out = paged_ops.paged_attention(**args)
    torch.cuda.synchronize()
    assert paged_ops.LAUNCHES[paged_ops.CACHED_NAME] == before + 1 + split
    assert not out[0].any()
    torch.testing.assert_close(out.float(),
                               paged_attention_ref(**args).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,g", [(32, 2), (128, 6)], ids=str)
def test_paged_attention_kernel_at_page_4(gen, hd, g, dtype):
    # the cached-only walk at page 4: every 16-key tile spans four pages
    lengths = [0, 1, 4, 701, 37, 333]
    case = paged_case(gen, 6, 1, 2, g, hd, 4, lengths, dtype, False)
    args = dict(q=case["q"][:, 0].contiguous(), k_pages=case["k_pages"],
                v_pages=case["v_pages"], block_tables=case["block_tables"],
                lengths=case["lengths"])
    split = dtype == torch.float32 and paged_ops.n_splits(
        6, 1, 2, g, torch.device("cuda"), False) > 1
    before = paged_ops.LAUNCHES[paged_ops.CACHED_NAME]
    out = paged_ops.paged_attention(**args)
    torch.cuda.synchronize()
    assert paged_ops.LAUNCHES[paged_ops.CACHED_NAME] == before + 1 + split
    assert not out[0].any()
    torch.testing.assert_close(out.float(),
                               paged_attention_ref(**args).float(),
                               **TOL[dtype])


def ssd_case(gen, b, s, H, P, N, dtype):
    """SSD scan inputs at the model's scales: x, B and C after the conv's
    SiLU, dt after softplus with init_mamba's dt_bias, A from its A_log."""
    rand = lambda *shape: torch.randn(shape, generator=gen,  # noqa
                                      device="cuda")
    dt_bias = torch.log(torch.expm1(torch.logspace(-3, -1, H,
                                                   device="cuda")))
    return (F.silu(rand(b, s, H, P)).to(dtype),
            F.softplus(rand(b, s, H) + dt_bias),
            -torch.linspace(1.0, 16.0, H, device="cuda"),
            F.silu(rand(b, s, N)).to(dtype), F.silu(rand(b, s, N)).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N,P", [(64, 64), (128, 64), (128, 128)], ids=str)
@pytest.mark.parametrize("s", [1, 127, 1001, 4096])
def test_ssd_scan_kernel(gen, s, N, P, dtype):
    x, dt, A, B, C = ssd_case(gen, 1 if s == 4096 else 2, s, 6, P, N, dtype)
    before = ssd_ops.LAUNCHES[ssd_ops.NAME]
    y, state = ssd_ops.ssd_scan(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES[ssd_ops.NAME] == before + 1
    y_ref, state_ref = ssd_scan_ref(x, dt, A, B, C)
    assert y.dtype == dtype and state.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), **TOL[dtype])
    torch.testing.assert_close(state, state_ref, **TOL[torch.float32])


@pytest.mark.parametrize("s", [64, 65, 1000, 4096, 4033])
def test_ssd_scan_tensor_cores_at_the_prefill_shape(gen, s):
    # the bf16 kernel (wgmma, W, S and w o x split in bf16 terms) at
    # mamba2-2.7b's widths; 65 and 4033 leave one row in the last chunk
    x, dt, A, B, C = ssd_case(gen, 1, s, 80, 64, 128, torch.bfloat16)
    y, state = ssd_ops.ssd_scan(x, dt, A, B, C)
    y_ref, state_ref = ssd_scan_ref(x, dt, A, B, C)
    torch.testing.assert_close(y.float(), y_ref.float(), **TOL[torch.bfloat16])
    torch.testing.assert_close(state, state_ref, **TOL[torch.float32])


def test_f32_kernels_keep_the_f32_tolerance(gen):
    # the CUDA-core f32 instantiations at the main paths' shapes
    q = torch.randn(1, 1023, 12, 128, generator=gen, device="cuda")
    k = torch.randn(1, 1023, 2, 128, generator=gen, device="cuda")
    v = torch.randn(1, 1023, 2, 128, generator=gen, device="cuda")
    torch.testing.assert_close(flash_ops.flash_attention(q, k, v),
                               flash_attention_ref(q, k, v),
                               **TOL[torch.float32])
    args = ssd_case(gen, 1, 1000, 80, 64, 128, torch.float32)
    y, state = ssd_ops.ssd_scan(*args)
    y_ref, state_ref = ssd_scan_ref(*args)
    torch.testing.assert_close(y, y_ref, **TOL[torch.float32])
    torch.testing.assert_close(state, state_ref, **TOL[torch.float32])


def test_paged_attention_is_built_with_tensor_cores(gen):
    # the bf16 page walk's products are mma.sync (HMMA) instructions
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    _build.library("paged_chunk_attention")
    sass = subprocess.run(
        [tool, "-sass", str(_build.library_path("paged_chunk_attention"))],
        capture_output=True, text=True, check=True).stdout
    assert "HMMA" in sass or "HGMMA" in sass


def test_bf16_kernels_are_built_with_wgmma(gen):
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in ("flash_attention", "ssd_scan"):
        _build.library(name)
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        assert "HGMMA" in sass, name


def test_ssd_scan_raises_instead_of_falling_back(gen):
    x, dt, A, B, C = ssd_case(gen, 1, 8, 2, 64, 32, torch.float32)
    with pytest.raises(ValueError, match="state dim"):
        ssd_ops.ssd_scan(x, dt, A, B, C)


def test_ssm_branching_on_the_card_matches_the_cpu(gen):
    """Prefill through K4, a 3-way fork, batched decode and a commit, on
    the card and on the CPU from one set of f32 weights."""
    cfg = dataclasses.replace(reduced(get_config("mamba2-2.7b")),
                              dtype="float32", ssm_state=64,
                              ssm_head_dim=64, num_layers=2)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 150))
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        logits, cache = model.prefill(p, torch.from_numpy(prompt).to(dev))
        store = BranchStore()
        store.snapshot_pytree(store.ROOT, cache)
        kids = store.fork(store.ROOT, 3)
        toks = [[t] for t in logits[0, -1].topk(3).indices.tolist()]
        for _ in range(4):
            batch = [store.restore_pytree(k, cache) for k in kids]
            c = {n: torch.cat([b[n] for b in batch], dim=1) for n in cache}
            logits, c = model.decode_step(
                p, c, torch.tensor([[t[-1]] for t in toks], device=dev),
                torch.zeros(3, device=dev))
            for i, k in enumerate(kids):
                store.write_many(k, store.flatten_pytree(
                    {n: v[:, i:i + 1].clone() for n, v in c.items()}))
                toks[i].append(int(logits[i, -1].argmax()))
        store.commit(kids[1])
        out[dev] = (toks, store.restore_pytree(store.ROOT, cache))
    assert out["cuda"][0] == out["cpu"][0]
    for n in ("conv", "ssm"):
        torch.testing.assert_close(out["cuda"][1][n].cpu(), out["cpu"][1][n],
                                   atol=1e-4, rtol=1e-4)


def test_hybrid_branching_on_the_card_matches_the_cpu(gen):
    """zamba2-7b's family at a tail-bearing depth: prefill through K4 and
    K2 at hd 112, a 3-way fork, batched decode (the shared block's K/V
    written into the concatenated batch) and a commit, card against CPU."""
    cfg = dataclasses.replace(reduced(get_config("zamba2-7b"),
                                      d_model=448, layers=5),
                              dtype="float32", num_heads=4, num_kv_heads=4,
                              head_dim=112, ssm_state=64, ssm_head_dim=64,
                              attn_every=2)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 150))
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        logits, cache = model.prefill(p, torch.from_numpy(prompt).to(dev),
                                      max_len=160)
        store = BranchStore()
        store.snapshot_pytree(store.ROOT, cache)
        kids = store.fork(store.ROOT, 3)
        toks = [[t] for t in logits[0, -1].topk(3).indices.tolist()]
        for i in range(4):
            batch = [store.restore_pytree(k, cache) for k in kids]
            c = {n: torch.cat([b[n] for b in batch], dim=1) for n in cache}
            logits, c = model.decode_step(
                p, c, torch.tensor([[t[-1]] for t in toks], device=dev),
                torch.full((3,), 150 + i, device=dev))
            for j, k in enumerate(kids):
                store.write_many(k, store.flatten_pytree(
                    {n: v[:, j:j + 1].clone() for n, v in c.items()}))
                toks[j].append(int(logits[j, -1].argmax()))
        store.commit(kids[1])
        out[dev] = (toks, store.restore_pytree(store.ROOT, cache))
    assert out["cuda"][0] == out["cpu"][0]
    for n in ("conv", "ssm", "k", "v"):
        torch.testing.assert_close(out["cuda"][1][n].cpu(), out["cpu"][1][n],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "dbrx-132b"])
@pytest.mark.parametrize("attn_impl", ["auto", "ref"])
def test_moe_engine_on_the_card_matches_the_cpu(gen, name, attn_impl):
    """The MoE FFN through the paged engine (capacity drops included),
    float32, card against CPU."""
    cfg = dataclasses.replace(reduced(get_config(name), d_model=128),
                              dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(model, params, num_pages=64, page_size=4,
                          max_pages_per_seq=16, device=dev,
                          attn_impl=attn_impl if dev == "cuda" else "auto")
        sid = eng.add_request([5, 17, 3, 42, 7, 11, 2, 9, 30, 4, 8, 1, 22])
        toks = eng.decode([sid])
        kids = eng.fork(sid, 3)
        toks += eng.decode(kids) + eng.decode(kids)
        toks += eng.spec_verify(kids[0], [[1, 2, 3]])[0]
        out[dev] = toks
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("name", ["paper-agentic", "dbrx-132b"])
def test_decode_graph_replay_matches_the_eager_step(gen, name):
    """20 fused decode steps of a small bf16 model (dbrx at capacity factor
    E/K: no row dropped) on rungs 1, 4 and 8, each step's graph replay held
    against the eager step the engine keeps (``_fused_forward``, unpadded)
    run on the same inputs after it: the greedy tokens agree on all but at
    most one step, the logits within one bf16 ulp of the step's largest.
    Each rung is captured once, after its first (eager) step, and replayed
    at every later one; the profiler sees K1 by name under replay, and
    K1's launch counter counts each launch a replay ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.serve_loop import _pad_pow2

    cfg = reduced(get_config(name), d_model=128)
    if cfg.is_moe:
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)
    model = Model(dataclasses.replace(cfg, dtype="bfloat16"))
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, num_pages=64, page_size=4,
                      max_pages_per_seq=16, device="cuda")
    pairs, rungs = [], set()

    def replay_then_eager(bt, lengths, pages, offsets, tokens, cow_src,
                          cow_dst, _real=eng._fused_decode_step):
        got = _real(bt, lengths, pages, offsets, tokens, cow_src,
                    cow_dst).float()
        want = eng._fused_forward(
            *eng._step_tensors(bt, lengths, pages, offsets, tokens),
            *_pad_pow2(cow_src, cow_dst, eng.device)).float()
        pairs.append((got, want))
        rungs.add(eng._decode_rung(len(tokens)).rows)
        return got
    eng._fused_decode_step = replay_then_eager
    sid = eng.add_request([5, 17, 3, 42, 7, 11, 2, 9, 30, 4, 8, 1, 22])
    for _ in range(4):
        eng.decode([sid])
    kids = eng.fork(sid, 3)
    for _ in range(8):
        eng.decode(kids)                  # the first faults 3 tail pages
    batch = kids + [eng.add_request([1, 2, 3, 4, 5, 6]),
                    eng.add_request([9, 8, 7])]
    for _ in range(8):
        eng.decode(batch)
    st = eng.stats()
    assert rungs == {1, 4, 8} and len(pairs) == 20
    assert st["decode_graph_captures"] == len(rungs)
    assert st["decode_graph_replays"] == len(pairs) - len(rungs)
    assert st["decode_padded_rows"] == 8 * 1 + 8 * 3
    flips = sum(not torch.equal(g.argmax(-1), w.argmax(-1))
                for g, w in pairs)
    assert flips <= 1, flips
    for g, w in pairs:
        ulp = 2 ** -7 * w.abs().max().item()
        torch.testing.assert_close(g, w, rtol=2 ** -7, atol=ulp)

    del eng._fused_decode_step            # the engine's own step again
    eng.decode(batch)                     # rung 8's replay, traced
    torch.cuda.synchronize()
    before = paged_ops.LAUNCHES[paged_ops.NAME]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.decode(batch)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    assert sum("paged_tc_kernel" in n for n in names) == cfg.num_layers, \
        sorted(set(names))
    assert paged_ops.LAUNCHES[paged_ops.NAME] - before == sum(
        "paged_tc_kernel" in n or "paged_chunk_combine" in n for n in names)
    assert eng.stats()["decode_graph_replays"] == len(pairs) - len(rungs) + 2


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_to(v, dev) for v in tree))
    return None if tree is None else tree.to(dev)


# ---------------------------------------------------------------------------
# training: the kernels under autograd
# ---------------------------------------------------------------------------

def _grads(out, inputs, g):
    return torch.autograd.grad(out, inputs, g)


def assert_grad_close(got, want):
    """A gradient is a sum over the batch and sequence whose terms are as
    large as its largest element, so its order noise is held to 1e-5 of
    that, beside TOL's relative term (one bf16 ulp)."""
    torch.testing.assert_close(
        got.float(), want.float(), rtol=TOL[want.dtype]["rtol"],
        atol=1e-5 * want.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1023, 2048])
def test_flash_attention_gradients_on_the_card(gen, s, dtype):
    """The K2 Function's gradients (the kernel forward, the chunked
    recompute backward) against autograd through the plain chunked
    attention, at qwen2-1.5b's widths; the forward is one launch."""
    from repro_torch.models.layers import chunked_causal_attention

    q, k, v, g = (torch.randn(1, s, n, 128, generator=gen, device="cuda")
                  .to(dtype).requires_grad_() for n in (12, 2, 2, 12))
    before = flash_ops.LAUNCHES[flash_ops.NAME]
    got = _grads(flash_ops.flash_attention(q, k, v, 1024), (q, k, v), g)
    assert flash_ops.LAUNCHES[flash_ops.NAME] == before + 1
    want = _grads(chunked_causal_attention(q, k, v, chunk=1024), (q, k, v),
                  g)
    for a, b in zip(got, want):
        assert_grad_close(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_scan_gradients_on_the_card(gen, dtype):
    """The K4 Function's gradients for x, dt, A, B, C against autograd
    through ``ssd_scan_ref``, at mamba2-2.7b's widths; dt and A get f32
    gradients."""
    args = [a.requires_grad_() for a in ssd_case(gen, 1, 2048, 80, 64, 128,
                                                  dtype)]
    y, state = ssd_ops.ssd_scan(*args)
    gy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
    got = _grads(y, args, gy)
    want = _grads(ssd_scan_ref(*args)[0], args, gy)
    assert got[1].dtype == got[2].dtype == torch.float32
    for a, b in zip(got, want):
        assert_grad_close(a, b)


def test_vmap_rules_launch_once_and_match_two_plain_calls(gen):
    from repro_torch.models.layers import chunked_causal_attention

    q, k, v = (torch.randn(2, 1, 1023, n, 128, generator=gen, device="cuda")
               for n in (12, 2, 2))
    before = flash_ops.LAUNCHES[flash_ops.NAME]
    out = torch.func.vmap(flash_ops.flash_attention)(q, k, v)
    assert flash_ops.LAUNCHES[flash_ops.NAME] == before + 1
    for i in range(2):
        torch.testing.assert_close(out[i], flash_attention_ref(q[i], k[i],
                                                               v[i]),
                                   **TOL[torch.float32])
    g = torch.randn_like(q)

    def f(q_, k_, v_, g_):
        return (flash_ops.flash_attention(q_, k_, v_) * g_).sum()
    got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)))(q, k, v, g)
    for i in range(2):
        qi, ki, vi = (x[i].clone().requires_grad_() for x in (q, k, v))
        want = _grads(chunked_causal_attention(qi, ki, vi), (qi, ki, vi),
                      g[i])
        for a, b in zip(got, want):
            assert_grad_close(a[i], b)
    x, dt, A, B, C = ssd_case(gen, 1, 1000, 80, 64, 128, torch.float32)
    xs = torch.stack([x, 0.5 * x])
    before = ssd_ops.LAUNCHES[ssd_ops.NAME]
    y, st = torch.func.vmap(ssd_ops.ssd_scan,
                            in_dims=(0, None, None, None, None))(
        xs, dt, A, B, C)
    assert ssd_ops.LAUNCHES[ssd_ops.NAME] == before + 1
    for i in range(2):
        yi, si = ssd_scan_ref(xs[i], dt, A, B, C)
        torch.testing.assert_close(y[i], yi, **TOL[torch.float32])
        torch.testing.assert_close(st[i], si, **TOL[torch.float32])


@pytest.mark.parametrize("name", ["paper-agentic", "mamba2-2.7b"])
def test_train_steps_on_the_card_match_the_cpu(gen, name):
    """Three float32 steps of build_train_step (AdamW, clip, accum 2) on
    the card and on the CPU from one state: losses and grad norms within
    1e-4 relative, parameters within 2 * lr per step (AdamW's first step is
    ±lr per element)."""
    from repro_torch.data import SyntheticLMPipeline
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import build_train_step, \
        init_train_state

    cfg = dataclasses.replace(reduced(get_config(name), d_model=128),
                              dtype="float32")
    if cfg.family == "ssm":
        # the SSD scan kernel takes N and P of 64 or 128
        cfg = dataclasses.replace(cfg, ssm_state=64, ssm_head_dim=64)
    model = Model(cfg, attn_chunk=32, loss_chunk=32)
    opt = adamw(1e-3)
    step = build_train_step(model, opt, accum_steps=2, clip_norm=1.0)
    state = init_train_state(model, opt, torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", "cuda"):
        st = _to(state, dev) if dev == "cuda" else state
        data = SyntheticLMPipeline(cfg, batch=4, seq=64, seed=1, device=dev)
        log = []
        for _ in range(3):
            st, met = step(st, data.next())
            log.append([float(met["loss"]), float(met["grad_norm"])])
        runs[dev] = (log, _to(st.params, "cpu"))
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for a, b in zip(_leaves(runs["cuda"][1]), _leaves(runs["cpu"][1])):
        torch.testing.assert_close(a, b, rtol=0, atol=3 * 2 * 1e-3)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def tp_cycle(eng):
    """The reference's tp serving cycle (decode, fork 2 with lazy CoW, 3
    steps, commit, a step) and a 4x4 verify; tokens and CoW counters."""
    sid = eng.add_request([5, 17, 3, 42, 7, 11, 2, 9, 30, 4, 8, 1, 22])
    toks = [eng.decode([sid])]
    kids = eng.fork(sid, 2)
    for _ in range(3):
        toks.append(eng.decode(kids))
    rows = eng.spec_verify(kids[1], [[1, 2, 3, 4], [4, 3, 2, 1],
                                     [7, 7, 7, 7], [9, 8, 7, 6]])
    parent = eng.commit(kids[0])
    toks.append(eng.decode([parent]))
    return toks, rows, eng.cow_dispatches, eng.cow_faults


TP_PATHS = {"fused": {}, "ref": {"attn_impl": "ref"},
            "int8": {"kv_dtype": "int8"}}


def tp_runs(devices, path, name="paper-agentic"):
    """``tp_cycle`` per named run: ``devices`` maps a run's name to its
    engine's (tp, device) options; float32, 2 layers."""
    cfg = get_config(name)
    if cfg.is_moe:
        cfg = dataclasses.replace(reduced(cfg, d_model=128),
                                  num_kv_heads=2)
    cfg = dataclasses.replace(cfg, dtype="float32", num_layers=2)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    out = {}
    for run, kw in devices.items():
        eng = ServeEngine(model, params, num_pages=64, page_size=4,
                          max_pages_per_seq=16, **TP_PATHS[path], **kw)
        out[run] = tp_cycle(eng)
        assert eng.tp == kw.get("tp", 1) == len(eng.shards)
    return out


@pytest.mark.parametrize("path", sorted(TP_PATHS))
def test_tp2_engine_on_one_card_matches_the_cpu(gen, path):
    """Two shards on one card (one kv head each for the MoE config, the
    kernels at the shards' shapes): the greedy tokens, verify rows and CoW
    counters of tp 1 on the card and of tp 2 on the CPU."""
    for name in ("paper-agentic", "qwen3-moe-235b-a22b"):
        out = tp_runs({"tp2": dict(tp=2, device="cuda:0"),
                       "tp1": dict(device="cuda:0"),
                       "cpu": dict(tp=2, device="cpu")}, path, name)
        assert out["tp2"] == out["tp1"] == out["cpu"], name


@pytest.mark.parametrize("path", sorted(TP_PATHS))
def test_tp2_engine_one_shard_a_card(gen, path):
    """One shard a card (``tp=2`` with no device takes cuda:0 and cuda:1;
    the partial sums cross between the cards): the tokens, verify rows and
    counters of tp 1 and of tp 2 on the CPU."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards: one shard a card")
    for name in ("paper-agentic", "qwen3-moe-235b-a22b"):
        out = tp_runs({"cards": dict(tp=2),
                       "tp1": dict(device="cuda:0"),
                       "cpu": dict(tp=2, device="cpu")}, path, name)
        assert out["cards"] == out["tp1"] == out["cpu"], name


def test_partial_product_keeps_the_f32_accumulator(gen):
    """A bf16 tensor-parallel partial on the card, one of two shards, is
    the product's f32 accumulator: rounded to bf16 it is the bf16 product
    (one device's result) within one ulp, it is the f32 product of the
    bf16 operands within f32 order noise, and its gradients are the bf16
    product's.  One shard's is the plain bf16 product."""
    from repro_torch.models.layers import partial_product

    x = torch.randn(96, 1536, generator=gen, device="cuda").bfloat16()
    w = torch.randn(1536, 768, generator=gen, device="cuda").bfloat16()
    xs = [x.clone().requires_grad_() for _ in range(2)]
    ws = [w.clone().requires_grad_() for _ in range(2)]
    wide = partial_product(xs[0][None], ws[0], 2)[0]
    narrow = xs[1] @ ws[1]
    assert wide.dtype == torch.float32
    assert torch.equal(partial_product(x, w, 1), x @ w)
    exact = x.float() @ w.float()
    torch.testing.assert_close(wide, exact, rtol=0,
                               atol=1e-5 * exact.abs().max().item())
    torch.testing.assert_close(wide.bfloat16().float(), narrow.float(),
                               **TOL[torch.bfloat16])
    g = torch.randn(96, 768, generator=gen, device="cuda").bfloat16()
    wide.backward(g.float())
    narrow.backward(g)
    assert torch.equal(xs[0].grad, xs[1].grad)
    assert torch.equal(ws[0].grad, ws[1].grad)


def card_mesh_state(name, devices, seed=0):
    """``name`` at full width and depth in bf16 over ``plan_mesh(devices)``
    (prefer model 2 for the SSM config, 1 for the dense), its state stored
    as blocks from the port's seeded init on the first card: (model, step,
    state)."""
    from repro_torch.optim import adamw
    from repro_torch.runtime.elastic import plan_mesh
    from repro_torch.runtime.train_loop import build_train_step, \
        init_train_state

    cfg = get_config(name)
    plan = plan_mesh(devices, prefer_model=2 if cfg.family == "ssm" else 1)
    model = Model(cfg, plan=plan)
    opt = adamw(1e-4)
    state = init_train_state(model, opt, torch.Generator(
        device=devices[0]).manual_seed(seed))
    return model, build_train_step(model, opt, clip_norm=1.0), state


def card_batch(cfg, b, s, seed=7):
    from repro_torch.data import SyntheticLMPipeline

    return SyntheticLMPipeline(cfg, batch=b, seq=s, seed=seed,
                               device="cuda:0").next()


def test_granite_trains_over_four_cards_a_quarter_of_its_state_a_card(gen):
    """``granite-8b`` at full width and depth in bf16 (b 4 × s 2048) over
    (data 4, model 1) of cuda:0..3, two steps of ``build_train_step``:
    finite losses, every card's peak under 80 GB, and each card's stored
    parameter and moment bytes within 10% of a quarter of the state's.
    One device would hold about 132 GB (16.5 GB of bf16 weights, 66.0 of
    f32 moments, 33.0 of the f32 accumulator, 16.5 of one position's
    gradients): it does not fit one card, and is not run.  Prints each
    card's peak and stored bytes (``-s``)."""
    from repro_torch.distributed.blocked import stored_bytes

    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip("needs 4 cards: one data position a card")
    cards = [torch.device("cuda", i) for i in range(4)]
    model, step, state = card_mesh_state("granite-8b", cards)
    assert model.plan.mesh.shape == {"data": 4, "model": 1}
    stored = stored_bytes((state.params, state.opt_state))
    total = sum(stored.values())
    batch = card_batch(model.cfg, 4, 2048)
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    losses = []
    for _ in range(2):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    peaks = {str(c): round(torch.cuda.max_memory_allocated(c) / 1e9, 2)
             for c in cards}
    print("FSDP_4CARD " + json.dumps({
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines(),
        "losses": losses, "step_peak_gb": peaks,
        "stored_gb": {str(d): round(v / 1e9, 3) for d, v in stored.items()},
        "state_gb": round(total / 1e9, 3)}))
    assert all(np.isfinite(losses))
    assert all(p < 80 for p in peaks.values()), peaks
    assert set(stored) == set(cards)
    for d, v in stored.items():
        assert abs(v - total / 4) <= 0.1 * total / 4, (d, v, total)


def test_mamba2_one_position_a_card_is_the_one_card_mesh(gen):
    """``mamba2-2.7b`` at full width and depth in bf16 (b 2 × s 2048) over
    (data 2, model 2) one position a card, against the same mesh on cuda:0
    alone: the first step's loss within 2**-7 relative (the same
    arithmetic, the partial sums crossing between the cards)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards: one mesh position a card")
    out = []
    for devices in (["cuda:0"] * 4, [f"cuda:{i}" for i in range(4)]):
        model, step, state = card_mesh_state("mamba2-2.7b", devices)
        assert model.plan.mesh.shape == {"data": 2, "model": 2}
        _, met = step(state, card_batch(model.cfg, 2, 2048))
        out.append(float(met["loss"]))
        del model, step, state, met
        torch.cuda.empty_cache()
    print(f"MAMBA2_4CARD first losses (one card, four cards): {out}")
    assert abs(out[1] / out[0] - 1) <= 2 ** -7, out
