#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught into success):

1. the card's name and power limit, torch and CUDA versions, and the build
   of every kernel from ``src/repro_torch/kernels/**/csrc`` with ``nvcc``;
2. each hand-written kernel against its plain PyTorch version on the card,
   at hd 32/128 and the main path's shapes, f32, bf16 and int8 pools, a CoW
   ``page_map`` and a zero-length row;
3. the main path at full width: ``qwen2-1.5b`` in bf16 with random weights
   from the port's seeded init, served by ``ServeEngine`` — 8 prompts of
   128-1024 tokens (two share a 512-token head, so one suffix prefill runs),
   4 lazy-CoW branches each, 32 decode steps at batch 32, a speculative
   verify, first-commit-wins, a checkpoint/restore, and a full release;
   the kernels' launch counters are zeroed just before and read just after;
4. end-to-end parity: the ``paper-agentic`` float32 engine on the card
   (kernels) and on the CPU (plain versions) must produce identical greedy
   tokens;
5. the timing of each kernel at the main path's shapes beside its plain
   version, the nearest single PyTorch call where one exists, and the
   card's bound; then the ``{"kernels": [...]}`` line, the card line and the
   final ``{"ok": true, ...}`` line.

It needs nothing but the checkout: no network, no weights on disk.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and dense
# operations/s by input type (f32 runs outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# (atol, rtol): |out - ref| <= atol + rtol * |ref| elementwise.  Both
# versions take the same inputs to f32, sum in f32 in different orders
# (~1e-6 apart) and round the result once to the output's type.  f32: the
# order noise only.  bf16: the two f32 sums can round to neighbouring bf16
# values, one ulp apart, and an ulp is at most 2**-7 of the value.
TOL = {torch.bfloat16: (2e-5, 2 ** -7), torch.float32: (2e-5, 0.0)}


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Timer:
    """Median device time of single launches, each after an L2 flush (the
    decode step streams every layer's weights between two attention calls,
    so the kernel meets a cold cache).  A spin on the card after the flush
    keeps it busy while the host enqueues the call, so the time between the
    events is the call's device time, not its Python overhead."""

    SPIN_CYCLES = 5_000_000     # ~2.5 ms at 1.98 GHz

    def __init__(self) -> None:
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)


def compare(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """Max abs error, mean |ref| and whether out is finite and within
    TOL of ref everywhere."""
    atol, rtol = TOL[ref.dtype]
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    ok = bool(torch.isfinite(o).all()) and bool(
        (diff <= atol + rtol * r.abs()).all())
    return {"max_abs_err": diff.max().item(),
            "mean_abs_ref": r.abs().mean().item(), "ok": ok}


def tol_text(c: dict, dtype) -> str:
    atol, rtol = TOL[dtype]
    return (f"max_abs_err={c['max_abs_err']:.3g} "
            f"(tol {atol:.3g} + {rtol:.3g}*|ref|, mean |ref| "
            f"{c['mean_abs_ref']:.3g}) {'ok' if c['ok'] else 'MISMATCH'}")


# ---------------------------------------------------------------------------
# kernel inputs
# ---------------------------------------------------------------------------

def paged_case(gen, *, b, t, kv, g, hd, page, lengths, dtype, quant=False,
               cow=False):
    """Inputs of paged_chunk_attention: disjoint pages per row, a spare
    region of the pool for CoW sources."""
    dev = "cuda"
    max_pages = max(1, -(-max(lengths) // page))
    n_pages = b * max_pages + 8

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    case = {
        "q": rand(b, t, kv, g, hd).to(dtype),
        "k_new": rand(b, t, kv, hd).to(dtype),
        "v_new": rand(b, t, kv, hd).to(dtype),
        "block_tables": torch.randperm(n_pages - 8, generator=gen,
                                       device=dev)[:b * max_pages]
        .reshape(b, max_pages).to(torch.int32).contiguous(),
        "lengths": torch.tensor(lengths, dtype=torch.int32, device=dev),
        "page_map": torch.arange(n_pages, dtype=torch.int32, device=dev),
    }
    kp, vp = rand(n_pages, page, kv, hd), rand(n_pages, page, kv, hd)
    if cow:   # the last row's first page reads a spare source page
        case["page_map"][case["block_tables"][-1, 0]] = n_pages - 1
    if quant:
        for name, fp in (("k", kp), ("v", vp)):
            sc = fp.abs().amax(dim=(1, 3)) / 127.0 + 1e-8
            case[f"{name}_pages"] = torch.round(
                fp / sc[:, None, :, None]).to(torch.int8)
            case[f"{name}_scales"] = sc.contiguous()
    else:
        case["k_pages"], case["v_pages"] = kp.to(dtype), vp.to(dtype)
    return case


def paged_cost(case) -> tuple:
    """(bytes, operations) this call must move and do: the cached K/V of
    each row up to its length, the chunk, q, the output and the table
    entries it walks."""
    b, t, kv, g, hd = case["q"].shape
    page = case["k_pages"].shape[1]
    qe = case["q"].element_size()
    pe = case["k_pages"].element_size()
    lens = case["lengths"].tolist()
    cached = sum(lens)
    pages = sum(-(-n // page) for n in lens)
    nbytes = (2 * b * t * kv * g * hd * qe          # q in, out
              + 2 * b * t * kv * hd * qe            # chunk K/V
              + 2 * cached * kv * hd * pe           # cached K/V
              + 2 * pages * 4 + 2 * b * 4)          # table, page_map, lengths
    if "k_scales" in case:
        nbytes += 2 * pages * kv * 4
    keys = sum(t * n + t * (t + 1) // 2 for n in lens)   # per (row group)
    ops = 4 * hd * kv * g * keys                         # q.k and p.v
    return nbytes, ops


def bound_ms(nbytes: int, ops: int, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_case(gen, *, s, h=12, kv=2, hd=128, dtype=torch.bfloat16):
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rand(1, s, h, hd), rand(1, s, kv, hd), rand(1, s, kv, hd)


def flash_cost(q, k) -> tuple:
    b, s, h, hd = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    ops = 4 * hd * h * b * s * (s + 1) // 2
    return nbytes, ops


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernels(gen) -> None:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import paged_chunk_attention
    from repro_torch.kernels.paged_attention.ref import (
        paged_chunk_attention_ref)

    log("== phase 2: kernels against their plain versions")
    for hd, g in ((32, 2), (128, 6)):
        for t in (1, 4, 300):
            for dtype, quant in ((torch.float32, False),
                                 (torch.bfloat16, False),
                                 (torch.bfloat16, True),
                                 (torch.float32, True)):
                case = paged_case(gen, b=3, t=t, kv=2, g=g, hd=hd, page=16,
                                  lengths=[0, 700, 333], dtype=dtype,
                                  quant=quant, cow=True)
                out = paged_chunk_attention(**case)
                torch.cuda.synchronize()
                c = compare(out, paged_chunk_attention_ref(**case))
                log(f"K1 paged_chunk_attention hd={hd} t={t} "
                    f"{str(dtype)[6:]}{' int8-pool' if quant else ''} "
                    f"cow+zero-length {tol_text(c, dtype)}")
                if not c["ok"]:
                    fail("paged_chunk_attention disagrees with its plain "
                         "version")
    for s in (1000, 2048):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_case(gen, s=s, dtype=dtype)
            out = flash_attention(q, k, v)
            torch.cuda.synchronize()
            c = compare(out, flash_attention_ref(q, k, v))
            log(f"K2 flash_attention h=12 kv=2 hd=128 s={s} "
                f"{str(dtype)[6:]} {tol_text(c, dtype)}")
            if not c["ok"]:
                fail("flash_attention disagrees with its plain version")


def phase_main_path(gen_seed: int = 0) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as k2
    from repro_torch.kernels.paged_attention import ops as k1
    from repro_torch.models import Model
    from repro_torch.runtime import ServeEngine

    log("== phase 3: main path, qwen2-1.5b bf16, random weights")
    cfg = get_config("qwen2-1.5b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(gen_seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"init {n_params / 1e9:.3f} B params in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = ServeEngine(model, params, page_size=16, num_pages=2048,
                      max_pages_per_seq=128, prefix_cache=True)
    rng = np.random.default_rng(gen_seed)
    lens = [1024, 768, 128, 256, 384, 512, 640, 896]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    prompts[1][:512] = prompts[0][:512]        # a shared 512-token head

    k1.LAUNCHES[k1.NAME] = 0
    k2.LAUNCHES[k2.NAME] = 0
    prefill_ms = []
    roots = []
    for p in prompts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        roots.append(eng.add_request(p))
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    st = eng.stats()
    if st["prefill_dispatches"] != len(prompts):
        fail(f"expected {len(prompts)} prefills, got {st}")
    branches = {r: eng.fork(r, 4) for r in roots}
    batch = [b for r in roots for b in branches[r]]
    step_ms = []
    for _ in range(32):
        t0 = time.perf_counter()
        out = eng.decode(batch)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if len(out) != 32 or not all(0 <= x < cfg.vocab_size for x in out):
            fail(f"bad decode output {out}")
    if eng.cow_faults != 32 or eng.cow_inline_steps != 1:
        fail(f"expected 32 inline CoW faults in one step: {eng.stats()}")
    # cached lengths the last timed step's kernel saw
    decode_lengths = [eng.kv.length(x) - 1 for x in batch]
    profile = profile_decode(eng, batch)
    probe = branches[roots[0]][0]
    verify_length = eng.kv.length(probe)
    drafts = [rng.integers(0, cfg.vocab_size, 4).tolist() for _ in range(4)]
    rows = eng.spec_verify(probe, drafts)
    if len(rows) != 4 or any(len(r) != 4 for r in rows):
        fail(f"bad spec_verify rows {rows}")
    for r in roots:
        eng.commit(branches[r][0])
    if eng.stats()["sequences_live"] != len(roots):
        fail(f"siblings survived first-commit-wins: {eng.stats()}")
    before = eng.spec_verify(roots[2], [[1, 2, 3]])
    freed = eng.checkpoint(roots[2])
    eng.restore(roots[2])
    after = eng.spec_verify(roots[2], [[1, 2, 3]])
    if before != after or not freed:
        fail(f"checkpoint/restore changed the branch: {before} {after}")
    final = eng.decode(roots)
    launches = {k1.NAME: k1.LAUNCHES[k1.NAME], k2.NAME: k2.LAUNCHES[k2.NAME]}
    torch.cuda.synchronize()
    for r in roots:
        eng.release(r)
    st = eng.stats()
    log(f"after release: {st}")
    if (st["sequences_live"] or st["pages_free"] + st["prefix_pages_cached"]
            != st["pages_total"]):
        fail("pool not drained back to full (free + prefix-cached pages)")
    log(f"launches on the main path: {launches}")
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    decode_p50 = statistics.median(step_ms)
    res = {
        "prefill_ms": [round(x, 3) for x in prefill_ms],
        "suffix_prefill_ms": round(prefill_ms[1], 3),
        "decode_step_ms_p50": round(decode_p50, 3),
        "decode_tokens_per_s": round(32 / decode_p50 * 1e3, 1),
        "final_tokens": final,
        "launches": launches,
        "decode_lengths": decode_lengths,
        "verify_length": verify_length,
        "profile": profile,
    }
    card = card_line()
    log(f"prefill ms per request (prompt {lens}): {res['prefill_ms']} "
        f"({card})")
    log(f"decode step ms p50 {decode_p50:.3f} (b=32), "
        f"{res['decode_tokens_per_s']} tokens/s ({card})")
    del eng, params
    torch.cuda.empty_cache()
    return res


def profile_decode(eng, batch, steps: int = 2) -> dict:
    """Device time by kernel and the idle share over a few decode steps
    (torch.profiler; host wall clock around the steps, which sync)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.decode(batch)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us, e.count, e.key))
    busy = sum(k[0] for k in kernels)
    if not busy:
        log("profile: device time not measured (no CUDA events)")
        return {"device_busy_ms_per_step": None, "idle_share": None}
    kernels.sort(reverse=True)
    log(f"profile over {steps} decode steps: wall {wall_us / steps / 1e3:.3f}"
        f" ms/step, device busy {busy / steps / 1e3:.3f} ms/step, idle "
        f"{1 - busy / wall_us:.3f}, {sum(k[1] for k in kernels) // steps} "
        "kernels/step")
    for us, count, name in kernels[:8]:
        log(f"  {us / steps / 1e3:8.3f} ms/step {count // steps:5d}x "
            f"{name[:90]}")
    k1 = [k for k in kernels if "paged_chunk_" in k[2]]  # attention, combine
    log(f"  K1 (attention + combine): "
        f"{sum(k[0] for k in k1) / steps / 1e3:.3f} ms/step, "
        f"{sum(k[1] for k in k1) // steps} launches/step")
    return {"device_busy_ms_per_step": busy / steps / 1e3,
            "idle_share": 1 - busy / wall_us}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def exercise(eng):
    """The JAX package's fast-path workout: decode, lazy-CoW fork of a
    partial tail page, three batched steps, commit, decode the winner."""
    out = []
    sid = eng.add_request([5, 17, 3, 42, 7, 11, 2, 9, 30, 4, 8, 1, 22])
    out += eng.decode([sid])
    kids = eng.fork(sid, 3)
    for _ in range(3):
        out += eng.decode(kids)
    eng.commit(kids[1])
    out += [eng.decode([sid])[0] for _ in range(8)]
    return out


def phase_parity() -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime import ServeEngine

    log("== phase 4: paper-agentic float32, card (kernels) vs CPU (plain)")
    # full float32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = {}
    for dev in ("cpu", "cuda"):
        for kv_dtype in (None, "int8"):
            eng = ServeEngine(model, params, num_pages=128, page_size=4,
                              max_pages_per_seq=16, kv_dtype=kv_dtype,
                              device=dev)
            tokens[dev, kv_dtype] = exercise(eng)
    for kv_dtype in (None, "int8"):
        same = tokens["cuda", kv_dtype] == tokens["cpu", kv_dtype]
        log(f"kv_dtype={kv_dtype}: greedy tokens identical={same} "
            f"({len(tokens['cpu', kv_dtype])} tokens)")
        if not same:
            fail(f"card {tokens['cuda', kv_dtype]} != cpu "
                 f"{tokens['cpu', kv_dtype]}")


@contextlib.contextmanager
def forced_splits(n: int):
    """Split K1's page walk into n ranges, one block each (the wrapper
    picks ``n_splits`` from the grid otherwise)."""
    from repro_torch.kernels.paged_attention import ops

    chosen = ops.n_splits
    ops.n_splits = lambda *args: n
    try:
        yield
    finally:
        ops.n_splits = chosen


def phase_timing(gen, main: dict) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import paged_chunk_attention
    from repro_torch.kernels.paged_attention.ref import (
        paged_chunk_attention_ref)

    log("== phase 5: kernel times at the main path's shapes "
        f"({card_line()})")
    timer = Timer()
    rows = []
    shapes = {
        "decode": dict(b=32, t=1, lengths=main["decode_lengths"]),
        "decode_len1024": dict(b=32, t=1, lengths=[1024] * 32),
        "verify": dict(b=4, t=4, lengths=[main["verify_length"]] * 4),
        "suffix_prefill": dict(b=1, t=255, lengths=[512]),
    }
    from repro_torch.kernels.paged_attention.ops import n_splits

    def check_k1(name, case, ref, splits):
        with forced_splits(splits):
            c = compare(paged_chunk_attention(**case), ref)
        log(f"K1 {name} splits={splits}: {tol_text(c, torch.bfloat16)}")
        if not c["ok"]:
            fail(f"paged_chunk_attention disagrees with its plain version "
                 f"at the main path's {name} shape, splits={splits}")
        return c

    k1 = {}
    for name, shp in shapes.items():
        case = paged_case(gen, kv=2, g=6, hd=128, page=16,
                          dtype=torch.bfloat16, **shp)
        splits = n_splits(shp["b"], shp["t"], 2, 6, torch.device("cuda"))
        ref = paged_chunk_attention_ref(**case)
        c = check_k1(name, case, ref, splits)
        ms = timer(lambda: paged_chunk_attention(**case))
        plain = timer(lambda: paged_chunk_attention_ref(**case), 5)
        bnd, by = bound_ms(*paged_cost(case), torch.bfloat16)
        k1[name] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                        max_abs_err=c["max_abs_err"])
        log(f"K1 {name} b={shp['b']} t={shp['t']} splits={splits}: "
            f"kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {bnd:.4f} ms ({by})")
        if splits > 1:
            # the split walk against one block per row: A B B A
            check_k1(name, case, ref, 1)
            t_split, t_one = [], []
            for order in ((splits, 1), (1, splits)):
                for n in order:
                    with forced_splits(n):
                        (t_split if n > 1 else t_one).append(
                            timer(lambda: paged_chunk_attention(**case)))
            log(f"K1 {name} split walk: splits={splits} "
                f"{statistics.mean(t_split):.4f} ms, splits=1 "
                f"{statistics.mean(t_one):.4f} ms (A B B A, each a "
                f"median of 20 cold-L2 launches)")
    d = k1["decode"]
    rows.append({
        "name": "paged_chunk_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_chunk_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:260",
        "launches": main["launches"]["paged_chunk_attention"],
        "max_abs_err": d["max_abs_err"], "ms": d["ms"],
        "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": None,
    })
    k2 = {}
    for s in (1023, 2048):
        q, k, v = flash_case(gen, s=s)
        c = compare(flash_attention(q, k, v), flash_attention_ref(q, k, v))
        log(f"K2 s={s}: {tol_text(c, torch.bfloat16)}")
        if not c["ok"]:
            fail(f"flash_attention disagrees with its plain version at the "
                 f"main path's s={s}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = timer(lambda: flash_attention(q, k, v))
        plain = timer(lambda: flash_attention_ref(q, k, v), 5)
        lib = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bnd, by = bound_ms(*flash_cost(q, k), torch.bfloat16)
        k2[s] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                     bound_by=by, max_abs_err=c["max_abs_err"])
        log(f"K2 s={s}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
    f = k2[1023]
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
        "launches": main["launches"]["flash_attention"],
        "max_abs_err": f["max_abs_err"], "ms": f["ms"],
        "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
        "bound_by": f["bound_by"], "library_ms": f["library_ms"],
    })
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test runs on "
             "a CUDA card")
    from repro_torch.kernels import _build

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log("== phase 1: build")
    secs = _build.build_all()
    log(f"built {sorted(_build.SOURCES)} in {secs:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        lines = text.splitlines()
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                if "Used " in ln and " registers" in ln]
        spills = [ln.strip() for ln in lines if "spill stores" in ln
                  and " 0 bytes spill stores" not in ln]
        log(f"{name}: {len(regs)} instantiations, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"spilling {spills or 'none'}")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    t0 = time.perf_counter()
    phase_kernels(gen)
    main_res = phase_main_path()
    phase_parity()
    rows = phase_timing(gen, main_res)
    log(f"total {time.perf_counter() - t0:.1f} s after the build")
    log("main path: " + json.dumps({k: main_res[k] for k in (
        "prefill_ms", "suffix_prefill_ms", "decode_step_ms_p50",
        "decode_tokens_per_s", "launches", "profile")}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
