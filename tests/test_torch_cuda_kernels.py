"""The port's CUDA kernels on the card (skipped without one).

A CUDA kernel has no CPU mode, so these tests run only on a machine with
a card: ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
Each kernel is held against its plain PyTorch version on the same inputs,
and the float32 engine on the card must decode the same greedy tokens as
on the CPU.  Both versions compute in float32 from the same inputs and
round once to the output's type, so float32 outputs differ by summation
order only (2e-5) and bfloat16 outputs by at most one ulp of the value
(2**-7 of it) plus that order noise.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import paged_chunk_attention_ref
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
@pytest.mark.parametrize("hd,g,t", [(32, 2, 1), (64, 1, 9), (128, 6, 40)],
                         ids=str)
def test_paged_chunk_attention_kernel(gen, hd, g, t, dtype, quant):
    case = paged_case(gen, 3, t, 2, g, hd, 16, [0, 70, 33], dtype, quant)
    split = paged_ops.n_splits(3, t, 2, g, torch.device("cuda")) > 1
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
    # end mid-page, a range can be empty, and the combine kernel merges
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s,h,kv,hd", [(1, 4, 2, 32), (77, 6, 2, 64),
                                       (300, 12, 2, 128)], ids=str)
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
