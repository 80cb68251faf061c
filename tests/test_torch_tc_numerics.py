"""The split-bf16 arithmetic of the tensor-core kernels, emulated on the CPU.

The bf16 instantiations of K2 (flash attention), K4 (SSD scan), K1 (paged
chunk attention) and K3 (cached-only paged attention) run their products
on Hopper's tensor cores, which take bf16 operands and sum into f32.  A
product of two bf16 inputs (q.k, C.B, anything times x or V; an int8 pool
value is exact in bf16) is exact in f32.  An operand that the kernel
computes in f32 (K2's and K1/K3's softmax weights P, the latter times the
int8 v-scale; K4's decay weights W, carried state S and weighted x) is
split into bf16 terms, ``hi = bf16(v)``, ``lo = bf16(v - hi)``, ..., and
every term goes through the tensor cores into the same f32 accumulator.

Each emulation below repeats its kernel's arithmetic tile by tile: the
kernel's tile sizes, bf16 operands, f32 accumulation, the kernel's order of
rescaling and accumulating, and one final rounding.  It is held against the
unchanged plain version under the unchanged tolerance ``TOL`` of the card
tests and ``chip_smoke.py``.  The number of terms of each product is the
smallest that meets ``TOL`` with margin (the unrounded error at most half
the bound) at every case; the kernels' sources carry the same numbers
(checked here).  With one term, a product either still meets ``TOL`` with
margin at every case (and then the kernel uses one term), or misses it,
which shows that the split is what holds ``TOL``.
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref,
    paged_chunk_attention_ref,
)
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

KERNELS = Path(flash_ops.__file__).resolve().parents[1]

# the card tests' and chip_smoke.py's tolerance, unchanged:
# |out - ref| <= atol + rtol * |ref|
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-5, 2 ** -7)}

ROWS = 64       # wgmma's M: K2's query tile and K4's row tile
KEYS = 64       # K2's key tile
LOG2E = 1.4426950408889634


def split(v: torch.Tensor, terms: int) -> list:
    """v (f32) as ``terms`` bf16 values (held in f32) whose sum is v to
    ~8 bits per term."""
    out = []
    for _ in range(terms):
        t = v.to(torch.bfloat16).float()
        out.append(t)
        v = v - t
    return out


def mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        terms: int) -> torch.Tensor:
    """acc + a @ b with a split into ``terms`` bf16 terms, each product
    summed into the f32 accumulator in turn (b is bf16-valued)."""
    for t in split(a, terms):
        acc = acc + t @ b
    return acc


# ---------------------------------------------------------------------------
# K2: causal GQA flash attention, 64 query rows by 64 keys per tile
# ---------------------------------------------------------------------------

def flash_tc(q, k, v, p_terms: int) -> torch.Tensor:
    """The bf16 kernel's arithmetic; returns the f32 output before its one
    rounding.  S = q.k^T in f32 (exact products), the online softmax in
    base 2 on the f32 scores, O = alpha O + P.V with P split, l the sum of
    the f32 P, out = O / l."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    nt = -(-s // ROWS)
    pad = nt * ROWS - s

    def heads(x, rep):          # [b, s, n, hd] -> [b, h, s_pad, hd] f32
        x = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).transpose(1, 2)
        return x.repeat_interleave(rep, dim=1)

    qt = heads(q, 1).reshape(b, h, nt, ROWS, hd)
    kf, vf = heads(k, g), heads(v, g)
    c = (1.0 / math.sqrt(hd)) * LOG2E
    m = torch.full((b, h, nt, ROWS, 1), float("-inf"))
    lsum = torch.zeros(b, h, nt, ROWS, 1)
    o = torch.zeros(b, h, nt, ROWS, hd)
    row = torch.arange(ROWS)[:, None]
    key = torch.arange(KEYS)[None, :]
    for j in range(nt):
        # query tiles i >= j walk key tile j; the diagonal one is masked
        act = torch.arange(nt) >= j
        kt = kf[:, :, None, j * KEYS:(j + 1) * KEYS]
        vt = vf[:, :, None, j * KEYS:(j + 1) * KEYS]
        t = (qt @ kt.transpose(-1, -2)) * c
        diag = (torch.arange(nt) == j)[:, None, None] & (key > row)
        t = t.masked_fill(diag, float("-inf"))
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(t - m_new)
        keep = act[:, None, None]
        lsum = torch.where(keep, lsum * alpha + p.sum(-1, keepdim=True), lsum)
        o = torch.where(keep, mma(o * alpha, p, vt, p_terms), o)
        m = torch.where(keep, m_new, m)
    out = (o / lsum).reshape(b, h, nt * ROWS, hd)[:, :, :s]
    return out.transpose(1, 2)


def flash_inputs(seed, s, h, kv, hd):
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            torch.bfloat16)
    return rand(1, s, h, hd), rand(1, s, kv, hd), rand(1, s, kv, hd)


# ---------------------------------------------------------------------------
# K4: the SSD scan, 64-row chunks
# ---------------------------------------------------------------------------

def ssd_tc(x, dt, A, B, C, terms: dict):
    """The bf16 kernel's arithmetic per 64-row chunk; returns y (f32,
    before its one rounding) and the f32 state.  ``terms`` names the split
    of W (y = W.x), S (y += exp(cum) C.S) and wx (S += B^T (w o x)).  The
    in-chunk decays are exp2 of differences of running sums in base 2; the
    state's weights w exp the direct suffix sums."""
    b, s, H, P = x.shape
    N = B.shape[-1]
    nc = -(-s // ROWS)
    pad = nc * ROWS - s

    def chunks(t):              # zero-padded tail, [b, nc, ROWS, ...] f32
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, ROWS, *t.shape[2:])

    xr, dtr, Br, Cr = chunks(x), chunks(dt), chunks(B), chunks(C)
    causal = torch.ones(ROWS, ROWS, dtype=torch.bool).tril()
    S = torch.zeros(b, H, N, P)
    ys = []
    for c in range(nc):
        xc = xr[:, c].permute(0, 2, 1, 3)                   # [b,H,k,P]
        dA = dtr[:, c] * A                                  # [b,ROWS,H]
        cum = torch.cumsum(dA, dim=1)
        cum2 = cum * LOG2E
        # sum_{i>k} dA_i, scanned from the end (not cum_last - cum_k)
        later = F.pad(dA[:, 1:], (0, 0, 0, 1))
        after = torch.flip(torch.cumsum(torch.flip(later, [1]), dim=1), [1])
        wk = dtr[:, c] * torch.exp(after)                   # [b,k,H]
        G = Cr[:, c] @ Br[:, c].transpose(-1, -2)           # [b,q,k]
        seg = cum2[:, :, None, :] - cum2[:, None, :, :]     # [b,q,k,H]
        W = (G[..., None] * torch.exp2(seg.masked_fill(
            ~causal[None, :, :, None], 0.0))) * dtr[:, c][:, None]
        W = W.masked_fill(~causal[None, :, :, None], 0.0).permute(0, 3, 1, 2)
        yc = mma(torch.zeros(b, H, ROWS, P), W, xc, terms["W"])
        y2 = mma(torch.zeros(b, H, P, ROWS), S.transpose(-1, -2),
                 Cr[:, c].transpose(-1, -2)[:, None], terms["S"])
        yc = yc + torch.exp(cum).permute(0, 2, 1)[..., None] * y2.transpose(
            -1, -2)
        ys.append(yc)
        # the chunk's update B^T (w o x) in an accumulator of its own (w o x
        # split), then one fma per element into the carried state
        wx = wk.permute(0, 2, 1)[..., None] * xc              # [b,H,k,P]
        U = torch.zeros(b, H, N, P)
        for t in split(wx, terms["wx"]):
            U = U + Br[:, c].transpose(-1, -2)[:, None] @ t
        S = S * torch.exp(cum[:, -1])[:, :, None, None] + U
    y = torch.stack(ys, dim=2).reshape(b, H, nc * ROWS, P)[:, :, :s]
    return y.permute(0, 2, 1, 3), S


def ssd_inputs(seed, s, H, P, N):
    """chip_smoke.py's ssd_case scales (x, B, C after the conv's SiLU, dt
    after softplus with init_mamba's dt_bias, A from its A_log) for H heads
    spread over mamba2-2.7b's 80, so the fastest decays are included."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))
    heads = torch.linspace(0, 79, H).round().long()
    dt_bias = torch.log(torch.expm1(torch.logspace(-3, -1, 80)))[heads]
    A = -torch.linspace(1.0, 16.0, 80)[heads]
    bf = torch.bfloat16
    return (F.silu(rand(1, s, H, P)).to(bf),
            F.softplus(rand(1, s, H) + dt_bias), A,
            F.silu(rand(1, s, N)).to(bf), F.silu(rand(1, s, N)).to(bf))


# ---------------------------------------------------------------------------
# K1 / K3: the paged walk, 16-key tiles, split over a thread-block cluster
# ---------------------------------------------------------------------------

PAGED_KEYS = 16     # keys per staged tile
H100_SMS = 132


def paged_tc(q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
             page_map, k_scales, v_scales, p_terms: int,
             n_split: int) -> torch.Tensor:
    """The bf16 kernel's arithmetic; returns the f32 output before its one
    rounding.  K3 is the same walk with no chunk (``k_new`` None) and no
    ``page_map``.  Per (sequence, kv head, row tile): the key tiles (cached
    positions in 16s, then the chunk keys the tile's rows can see) are cut
    into ``n_split`` contiguous shares, one per cluster rank.  Rows <= 16:
    one 16-row tile whose 4 warps take every 4th tile of the rank's share,
    merged in warp order; more rows: 64-row tiles, every row over the whole
    share.  A tile: S = q.k^T (exact products) times c = scale log2(e)
    times the int8 k-scale, base-2 online softmax, O = alpha O + (P o
    v-scale).V with that operand split into bf16 terms, l summing the f32
    P.  Rank 0 merges the ranks in order; a row that saw no key is 0."""
    b, t, kv, g, hd = q.shape
    page = k_pages.shape[1]
    rows = t * g
    tile_rows = paged_ops.TC_ROWS[rows > paged_ops.ONE_WARP_ROWS]
    c = (1.0 / math.sqrt(hd)) * LOG2E
    out = torch.zeros(b, rows, kv, hd)
    for bi in range(b):
        n = int(lengths[bi])
        pos = torch.arange(n)
        phys = block_tables[bi].long()[pos // page]
        if page_map is not None:
            phys = page_map.long()[phys]
        for h in range(kv):
            kc = k_pages[phys, pos % page, h].float()     # as stored
            vc = v_pages[phys, pos % page, h].float()
            ks = vs = torch.ones(n)
            if k_scales is not None:
                ks, vs = k_scales[phys, h], v_scales[phys, h]
            qr = q[bi, :, h].float().reshape(rows, hd)
            for r0 in range(0, rows, tile_rows):
                rr = torch.arange(r0, min(rows, r0 + tile_rows))
                j_end = 0 if k_new is None else min(t, int(rr[-1]) // g + 1)
                tiles = [("cached", i) for i in range(-(-n // PAGED_KEYS))]
                tiles += [("chunk", i) for i in range(-(-j_end // PAGED_KEYS))]
                per = -(-len(tiles) // n_split)
                m, l, acc = _merge([
                    _walk(qr[rr], rr, tiles[rank * per:(rank + 1) * per], kc,
                          vc, ks, vs, k_new, v_new, bi, h, g, t, n, c, p_terms)
                    for rank in range(n_split)])
                o = torch.where(l[:, None] > 0, acc / l[:, None],
                                torch.zeros(()))
                out[bi, rr, h] = o
    return out.reshape(b, t, g, kv, hd).permute(0, 1, 3, 2, 4)


def _walk(qr, rr, tiles, kc, vc, ks, vs, k_new, v_new, bi, h, g, t, n, c,
          p_terms):
    """One rank's online softmax over its share of the tiles."""
    R, hd = qr.shape
    m = torch.full((R,), float("-inf"))
    l = torch.zeros(R)
    o = torch.zeros(R, hd)
    key = torch.arange(PAGED_KEYS)
    for kind, i in tiles:
        j0 = i * PAGED_KEYS
        if kind == "cached":
            sel = slice(j0, min(n, j0 + PAGED_KEYS))
            K, V, cs, vsc = kc[sel], vc[sel], c * ks[sel], vs[sel]
            lim = torch.full((R,), n - j0)
        else:
            sel = slice(j0, min(t, j0 + PAGED_KEYS))
            K, V = k_new[bi, sel, h].float(), v_new[bi, sel, h].float()
            cs, vsc = torch.full((K.shape[0],), c), torch.ones(K.shape[0])
            lim = torch.clamp(rr // g + 1, max=t) - j0
        pad = PAGED_KEYS - K.shape[0]           # zero-filled keys
        K, V = F.pad(K, (0, 0, 0, pad)), F.pad(V, (0, 0, 0, pad))
        cs, vsc = F.pad(cs, (0, pad), value=c), F.pad(vsc, (0, pad), value=1.0)
        s = (qr @ K.T) * cs
        s = s.masked_fill(key[None, :] >= lim[:, None], float("-inf"))
        mn = torch.maximum(m, s.amax(-1))
        mu = torch.where(mn == float("-inf"), torch.zeros(()), mn)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s - mu[:, None])
        l = l * alpha + p.sum(-1)
        o = mma(o * alpha[:, None], p * vsc, V, p_terms)
        m = mn
    return m, l, o


def _merge(parts):
    """The kernel's merge of softmax partials, in order; a partial with
    l = 0 saw no key."""
    m = torch.stack([x[0] for x in parts])
    l = torch.stack([x[1] for x in parts])
    acc = torch.stack([x[2] for x in parts])
    seen = l > 0
    mx = torch.where(seen, m, torch.full_like(m, float("-inf"))).amax(0)
    w = torch.where(seen, torch.exp2(m - mx), torch.zeros(()))
    return mx, (w * l).sum(0), (w[..., None] * acc).sum(0)


def paged_inputs(seed, b, t, kv, g, hd, lengths, quant, page=16):
    """chip_smoke.py's paged_case made with numpy: disjoint pages per row,
    the last row's first page redirected to a spare page (CoW)."""
    rng = np.random.default_rng(seed)
    max_pages = max(1, -(-max(lengths) // page))
    n_pages = b * max_pages + 8

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))
    bf = torch.bfloat16
    case = {
        "q": rand(b, t, kv, g, hd).to(bf),
        "k_new": rand(b, t, kv, hd).to(bf),
        "v_new": rand(b, t, kv, hd).to(bf),
        "block_tables": torch.from_numpy(rng.permutation(n_pages - 8)[
            :b * max_pages].reshape(b, max_pages).astype(np.int32)),
        "lengths": torch.tensor(lengths, dtype=torch.int32),
        "page_map": torch.arange(n_pages, dtype=torch.int32),
    }
    case["page_map"][case["block_tables"][-1, 0]] = n_pages - 1
    kp, vp = rand(n_pages, page, kv, hd), rand(n_pages, page, kv, hd)
    if quant:
        for name, fp in (("k", kp), ("v", vp)):
            sc = fp.abs().amax(dim=(1, 3)) / 127.0 + 1e-8
            case[f"{name}_pages"] = torch.round(
                fp / sc[:, None, :, None]).to(torch.int8)
            case[f"{name}_scales"] = sc
    else:
        case["k_pages"], case["v_pages"] = kp.to(bf), vp.to(bf)
        case["k_scales"] = case["v_scales"] = None
    return case


RAGGED = [0, 1, 16, 17, 333, 700, 1055, 40]
#: (name, b, t, g, hd, lengths, int8 pools, K3): decode, verify and suffix
#: prefill at qwen2-1.5b's widths (kv 2, g 6, hd 128), at stablelm-12b's
#: head (g 4, hd 160: 10 k16 steps of q.k, 20 n8 tiles of P.V), and hd 32
#: / 64
PAGED_CASES = [
    ("decode", 8, 1, 6, 128, RAGGED, False, False),
    ("decode_int8", 8, 1, 6, 128, RAGGED, True, False),
    ("k3_decode", 8, 1, 6, 128, RAGGED, False, True),
    ("verify", 4, 4, 6, 128, [0, 1, 500, 1000], False, False),
    ("verify_int8", 4, 4, 6, 128, [0, 1, 500, 1000], True, False),
    ("suffix_prefill", 1, 255, 6, 128, [512], False, False),
    ("hd32_decode", 3, 1, 2, 32, [0, 700, 33], False, False),
    ("hd32_verify_int8", 3, 4, 2, 32, [0, 700, 33], True, False),
    ("hd32_k3", 6, 1, 2, 32, [0, 1, 16, 700, 1055, 333], False, True),
    ("hd64_t9", 3, 9, 1, 64, [0, 70, 33], False, False),
    ("hd32_t40_int8", 3, 40, 2, 32, [0, 700, 33], True, False),
    ("hd160_decode", 8, 1, 4, 160, RAGGED, False, False),
    ("hd160_decode_int8", 8, 1, 4, 160, RAGGED, True, False),
    ("hd160_k3", 8, 1, 4, 160, RAGGED, False, True),
    ("hd160_verify", 4, 4, 4, 160, [0, 1, 500, 1000], False, False),
    ("hd160_suffix_prefill", 1, 255, 4, 160, [512], False, False),
]
_PAGED_REF = {}


def _paged(case, p_terms):
    name, b, t, g, hd, lengths, quant, cached = case
    args = paged_inputs(len(name) + hd, b, t, 2, g, hd, lengths, quant)
    n_split = paged_ops.split_count(b, t, 2, g, H100_SMS)
    f32 = {k: (v.float() if v is not None and v.dtype == torch.bfloat16
               else v) for k, v in args.items()}
    if cached:
        args.update(k_new=None, v_new=None, page_map=None)
        if name not in _PAGED_REF:
            _PAGED_REF[name] = paged_attention_ref(
                f32["q"][:, 0], f32["k_pages"], f32["v_pages"],
                f32["block_tables"], f32["lengths"])[:, None]
    elif name not in _PAGED_REF:
        _PAGED_REF[name] = paged_chunk_attention_ref(**f32)
    out = paged_tc(**args, p_terms=p_terms, n_split=n_split)
    return ratios(out, _PAGED_REF[name], torch.bfloat16)


# ---------------------------------------------------------------------------
# measures
# ---------------------------------------------------------------------------

def ratios(out_f32: torch.Tensor, ref_f32: torch.Tensor, dtype) -> dict:
    """``raw``: max unrounded |out - ref| over the TOL bound; ``tol``: the
    same after both are rounded to ``dtype`` (<= 1 meets TOL).  Meeting TOL
    with margin is raw <= 0.5."""
    atol, rtol = TOL[dtype]
    raw = ((out_f32 - ref_f32).abs() / (atol + rtol * ref_f32.abs())).max()
    o, r = out_f32.to(dtype).float(), ref_f32.to(dtype).float()
    tol = ((o - r).abs() / (atol + rtol * r.abs())).max()
    return {"raw": raw.item(), "tol": tol.item()}


#: (s, h, kv, hd): qwen2-1.5b's prefill widths, stablelm-12b's hd 160 (five
#: 32-column panels, the same sums per output element), musicgen-
#: medium's MHA (g 1, hd 64) and zamba2-7b's hd 112 (staged as 128: the
#: zero columns add exact zeros)
FLASH_CASES = [(1, 12, 2, 128), (77, 12, 2, 128), (1023, 12, 2, 128),
               (40, 4, 2, 32), (130, 4, 1, 64), (300, 8, 2, 160),
               (1023, 4, 1, 160), (130, 4, 4, 64), (300, 4, 4, 112)]
SSD_CASES = [(s, 3, 64, N) for s in (1, 63, 64, 65, 1000, 4096)
             for N in (128, 64)]


def _flash(case, p_terms):
    s, h, kv, hd = case
    q, k, v = flash_inputs(s, s, h, kv, hd)
    ref = flash_attention_ref(q.float(), k.float(), v.float())
    return ratios(flash_tc(q, k, v, p_terms), ref, torch.bfloat16)


_SSD_REF = {}


def _ssd(case, terms):
    s, H, P, N = case
    args = ssd_inputs(s + N, s, H, P, N)
    if case not in _SSD_REF:
        f32 = (args[0].float(), *args[1:3], args[3].float(), args[4].float())
        _SSD_REF[case] = ssd_scan_ref(*f32)
    y_ref, state_ref = _SSD_REF[case]
    y, state = ssd_tc(*args, terms)
    return (ratios(y, y_ref, torch.bfloat16),
            ratios(state, state_ref, torch.float32))


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_split_meets_tol_with_margin(case):
    r = _flash(case, flash_ops.SPLIT_TERMS["P"])
    assert r["tol"] <= 1.0 and r["raw"] <= 0.5, r


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_split_meets_tol_with_margin(case):
    ry, rs = _ssd(case, ssd_ops.SPLIT_TERMS)
    assert ry["tol"] <= 1.0 and ry["raw"] <= 0.5, ry
    assert rs["tol"] <= 1.0 and rs["raw"] <= 0.5, rs


@pytest.mark.parametrize("N", [64, 128])
def test_ssd_state_is_f32_grade_at_its_magnitude(N):
    """The f32 state's error relative to its own largest magnitude at s
    2048: within 2**-20 with the kernel's terms, whatever that magnitude
    (the tolerance's 2e-5 is absolute); with two terms of w o x it is ~3e-6
    of it, which misses 2e-5 once a state element passes ~7 (the card met
    that at b 1, s 2048, N 64: tools/k4_state_error.py)."""
    s, H, P = 2048, 3, 64
    args = ssd_inputs(s + N, s, H, P, N)
    f32 = (args[0].float(), *args[1:3], args[3].float(), args[4].float())
    _, ref = ssd_scan_ref(*f32)
    scale = float(ref.abs().max())
    rel = {wx: float((ssd_tc(*args, dict(ssd_ops.SPLIT_TERMS, wx=wx))[1]
                      - ref).abs().max()) / scale
           for wx in (2, ssd_ops.SPLIT_TERMS["wx"])}
    print(f"K4 state error over its largest magnitude by wx terms: {rel}")
    assert rel[ssd_ops.SPLIT_TERMS["wx"]] <= 2 ** -20 < rel[2], rel


def test_flash_one_term_p_misses():
    """P in bf16 alone: the error is reported, and it misses the margin
    somewhere, so the kernel splits P."""
    found = {str(c): _flash(c, 1) for c in FLASH_CASES}
    print("K2 with one-term P:", found)
    assert flash_ops.SPLIT_TERMS["P"] > 1
    assert max(r["raw"] for r in found.values()) > 0.5, found


@pytest.mark.parametrize("product", ["W", "S", "wx"])
def test_ssd_one_term_product(product):
    """Each of K4's split products with one term (the others as the kernel
    has them): where it meets TOL with margin everywhere the kernel uses one
    term; where it misses, the kernel splits it."""
    terms = dict(ssd_ops.SPLIT_TERMS, **{product: 1})
    found = {}
    for c in SSD_CASES:
        ry, rs = _ssd(c, terms)
        found[str(c)] = max(ry["raw"], rs["raw"])
    print(f"K4 with one-term {product}: worst raw ratio {found}")
    if ssd_ops.SPLIT_TERMS[product] == 1:
        assert max(found.values()) <= 0.5, found
    else:
        assert max(found.values()) > 0.5, found




@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: c[0])
def test_paged_split_meets_tol_with_margin(case):
    r = _paged(case, paged_ops.SPLIT_TERMS["P"])
    assert r["tol"] <= 1.0 and r["raw"] <= 0.5, r


def test_paged_one_term_p_misses():
    """P (times the int8 v-scale) in bf16 alone: the error is reported, and
    it misses the margin somewhere, so the kernel splits it."""
    found = {c[0]: _paged(c, 1) for c in PAGED_CASES}
    print("K1/K3 with one-term P:", found)
    assert paged_ops.SPLIT_TERMS["P"] > 1
    assert max(r["raw"] for r in found.values()) > 0.5, found


@pytest.mark.parametrize("rows,b,kv,splits", [
    (6, 32, 2, 8), (24, 4, 2, 16), (1530, 1, 2, 5), (6, 8, 2, 16),
    (6, 600, 2, 1)])
def test_paged_split_counts(rows, b, kv, splits):
    """The bf16 walk's split over the cluster at the main paths' shapes on
    an H100 (132 SMs): decode b=32, verify 4x4, suffix prefill t=255, a
    small decode batch (the widest cluster) and a batch that fills the
    card alone."""
    assert paged_ops.split_count(b, rows, kv, 1, H100_SMS) == splits
    assert splits <= paged_ops.MAX_SPLITS


@pytest.mark.parametrize("name,terms,pattern", [
    ("flash_attention/csrc/flash_attention.cu", flash_ops.SPLIT_TERMS,
     r"constexpr int k(\w+)Terms = (\d+);"),
    ("paged_attention/csrc/paged_chunk_attention.cu", paged_ops.SPLIT_TERMS,
     r"constexpr int k(\w+)Terms = (\d+);"),
    ("ssd_scan/csrc/ssd_scan.cu", ssd_ops.SPLIT_TERMS,
     r"constexpr int k(\w+)Terms = (\d+);")])
def test_kernel_sources_use_these_term_counts(name, terms, pattern):
    found = re.findall(pattern, (KERNELS / name).read_text())
    assert {k.lower(): int(v) for k, v in found} == {
        k.lower(): v for k, v in terms.items()}


def test_paged_wrapper_uses_the_kernel_tiles():
    """The wrapper picks the split from the kernel's row tiles."""
    src = (KERNELS / "paged_attention/csrc/paged_chunk_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert paged_ops.ONE_WARP_ROWS == const("TC_ONE_WARP_ROWS")
    assert paged_ops.TC_ROWS == (16, 16 * const("TC_WARPS"))
    assert paged_ops.MAX_SPLITS == const("MAX_CLUSTER")
