#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught into success):

1. the card's name and power limit, torch and CUDA versions, and the build
   of every kernel from ``src/repro_torch/kernels/**/csrc`` with ``nvcc``
   (one process per source, all at once), with ptxas's registers and spills
   and the count of tensor-core instructions in each library: the
   flash-attention and SSD-scan libraries must have ``HGMMA`` (wgmma) and
   the paged-attention library ``HMMA`` (mma.sync) or ``HGMMA`` (their bf16
   kernels run on the tensor cores);
2. each hand-written kernel against its plain PyTorch version on the card:
   paged chunk attention (K1) at hd 32/128, f32, bf16 and int8 pools, a CoW
   ``page_map`` and a zero-length row, at page 16 and page 8, t up to 300
   (t=8 at g=6 is a speculative verify), and at page 4 (the front door's
   parity geometry: t 1, 4 and 37), and at stablelm-12b's head (hd 160,
   g 4; t 1, 4 and 255; f32, bf16 and int8 pools; pages 16 and 4); flash
   attention (K2) at qwen2-1.5b's widths, at hd 160 (h 32, kv 8) and at
   musicgen-medium's MHA (g 1, hd 64), at zamba2-7b's shared block (h 32
   = kv, hd 112, staged as hd 128 with zero columns), at
   qwen3-moe-235b-a22b's (h 64, kv 4: g 16) and dbrx-132b's (h 48, kv 8),
   s 1023 and 2048, bf16 and f32; K1 also at g 16 (t 1, 4 and 255; f32,
   bf16 and int8 pools; pages 16 and 4);
   cached-only paged attention (K3) at qwen2-1.5b's widths and at hd 160,
   b=32, ragged lengths, pages 16 and 4; the SSD scan (K4) at
   mamba2-2.7b's widths (80 heads, P 64, N 128, and N 64), s 1000 and
   4096, bf16 and f32; then training's autograd Functions: K2's gradients
   for q, k, v at qwen2-1.5b's widths (s 1023 and 2048) and K4's for x,
   dt, A, B, C at mamba2-2.7b's (s 1000 and 2048), f32 and bf16, against
   autograd through the plain versions, and each vmap rule over 2
   branches (one launch) against two plain calls;
3. the dense path at full width: ``qwen2-1.5b`` in bf16 with random weights
   from the port's seeded init, served by ``ServeEngine`` — 8 prompts of
   128-1024 tokens (two share a 512-token head, so one suffix prefill runs),
   4 lazy-CoW branches each, decode steps at batch 32, a speculative
   verify, first-commit-wins, a checkpoint/restore, and a full release;
   first on the fused path, then (path B) on the legacy ``attn_impl="ref"``
   path for 8 steps; each bf16 K1/K3/K2 call must be one launch, and no
   split combine kernel may run in the profiled steps;
4. the SSM path at full width (path A): ``mamba2-2.7b`` in bf16 with random
   weights, 4 prompts of 1000-4096 tokens prefilled through the SSD scan,
   each cache snapshotted into its own ``BranchStore`` and forked 8 ways,
   32 decode steps of all 32 branches as one batch, one winner committed
   per request, its siblings stale and reaped, device memory back to where
   it was before the fork;
5. end-to-end parity, card (kernels) against CPU (plain versions): the
   ``paper-agentic`` float32 engine, fused and legacy, identical greedy
   tokens; a paper-agentic-sized engine at hd 160 (d 640, 4 heads, kv 2,
   2 layers), fused and legacy, identical greedy tokens; musicgen-medium's
   and pixtral-12b's widths at 2 layers (pixtral with a 16-patch
   ``frontend_embed``) through ``Model.prefill`` and contiguous
   ``decode_step``s, identical greedy tokens (per codebook); the
   mamba2-2.7b widths at 4 layers in float32, the branching cycle,
   identical tokens and committed state within 1e-4; zamba2-7b's widths at
   7 layers (one shared-block application and a one-layer tail), the same
   cycle over the hybrid cache, identical tokens and committed state
   within 1e-4 + 1e-4 |cpu|; qwen3-moe-235b-a22b's and dbrx-132b's widths
   at 2 layers through the engine, fused and legacy, identical greedy
   tokens and expert ids at every routing call; a greedy
   ``BranchSession`` run and a ``speculative_decode`` round, identical
   tokens and verified prefixes; the front door in process
   (``FrontDoor.dispatch``, page 4): a greedy ``/v1/generate`` stream with
   identical events and tokens, and a ``best_of_n`` ``/v1/explore`` that
   commits exactly one winner and drains the pool on either device;
   training in float32: ``paper-agentic`` and mamba2-2.7b's widths at 4
   layers through 3 steps of ``build_train_step`` (AdamW, clip, accum 2),
   losses, grad norms and parameters card vs CPU; on the card a
   ``FaultTolerantTrainer`` NaN rollback to a bit-identical state, a
   checkpoint at step 4 restored to replay the stream, a
   ``speculative_step`` with one replica delayed and one killed, and a
   ``SpeculativeTrainer`` round under ``set_sync_debug_mode("error")``
   with the CPU's winner;
6. the public branch API at full width: ``qwen2-1.5b`` bf16 served through
   ``BranchSession`` and ``ExplorationDriver`` — 8 prompts (phase 3's),
   best-of-4 on four, beam search on two, tree search on one and a
   speculative round on one, in one continuous batch; every exploration
   must commit one winner per exclusive group, K1/K2 launches must equal
   their calls, and the pool must drain; the session's step, its host cost
   outside the engine's decode, and fork/commit latency are printed beside
   the engine's own; then a pool too small for every fork (one exploration
   must degrade, the pool must drain), and ``python -m
   repro_torch.launch.serve --arch qwen2-1.5b`` as a subprocess;
7. the HTTP/SSE front door at full width: ``qwen2-1.5b`` bf16 behind
   ``FrontDoor.serve`` on a local socket, tenants ``interactive`` (16 live,
   priority 2) and ``batch`` (8 live, priority 1, a page quota of one
   hold); eight concurrent ``ServeClient`` requests on phase 3's prompts
   (4 streamed greedy ``/v1/generate``, 2 ``best_of_n``, 1 ``beam``, 1
   held ``batch`` request), a ``batch`` request over quota (429, the
   scheduler's ledger untouched), ``/metrics``, ``/v1/tenants``, the tree
   and ``/healthz``, then a drain with a stream in flight (it finishes, the
   hold is evicted, new work answers 503, the pool drains); the time to
   first token, tokens/s and the engine loop's ms per step beside
   ``session.step``'s are printed; then an 80-page pool where held
   ``batch`` requests are demoted to seat the waiting chats (no lossy
   preemption) and the drain's eviction events carry their chains; then
   ``python -m repro_torch.launch.serve --serve 127.0.0.1:0`` as a
   subprocess, two requests, SIGINT, a clean drain;
8. ``repro_torch.core.explore`` on the card under
   ``torch.cuda.set_sync_debug_mode("error")``: the winner is the argmin
   of ``aux``, the origin is kept when nothing succeeds, gradient descent
   converges, and a key gives the CPU's bits;
9. BranchFS on the card's host: ``create`` µs over bases of 10 to 10 000
   files, ``commit`` µs for 1 to 100 modified files, each commit leaving
   its sibling stale;
11. (run before 10, which times its shapes) the other families at full
   width and depth in bf16, random weights, one config at a time, each
   freed before the next, with its init peak and largest allocation:
   ``granite-8b``, ``nemotron-4-15b``, ``stablelm-12b`` (hd 160) and
   ``pixtral-12b`` (text) through ``ServeEngine`` — page 16, 2048 pages,
   prefix cache on, prompts of 1024, 768 (512 of them shared, so one
   suffix prefill runs through K1), 384 and 128 tokens, 4 lazy-CoW
   branches each (b = 16), 16 fused steps, a 4×4 verify, commit, a
   checkpoint/restore, release to a full pool (phase 3's load, smaller),
   then the load again on ``attn_impl="ref"`` for 4 steps; K1/K2/K3
   launches equal their calls; prefill ms, step p50, tokens/s and the
   device-busy share of 2 profiled steps.  Then
   pixtral-12b through ``Model.prefill`` with a ``[2, 1024, 5120]``
   ``frontend_embed`` and 128 text tokens (K2 over 1152 positions) and 16
   contiguous decode steps, and musicgen-medium (b = 8 prompts of 512
   frames × 4 codebooks, ``max_len`` 1024, 32 contiguous decode steps);
12. (run before 10, after 11) zamba2-7b at full width and depth in bf16
   through ``Model`` and ``BranchStore`` — prompts of 512, 1024, 1536
   and 2048 tokens (81 SSD-scan and 13 hd 112 flash-attention launches
   each), each in its own store forked 4 ways (b = 16) into a 2080-position
   cache, 32 batched steps, one winner committed per request, its siblings
   stale and reaped, device memory back within 5%; then
   qwen3-moe-235b-a22b (12 of 94 layers) and dbrx-132b (8 of 40) at full
   width through ``ServeEngine`` with phase 11's load; each config freed
   before the next, with its init peak, largest allocation, prefill ms,
   step p50, tokens/s and device-busy share;
13. (run before 10, after 12) training at full width and depth in bf16,
   random weights, through ``FaultTolerantTrainer`` (no checkpoint
   manager), one config at a time: ``qwen2-1.5b`` at b 4 × s 2048 and
   ``mamba2-2.7b`` at b 2 × s 2048, 8 steps of AdamW (``cosine_warmup``),
   clip 1.0, remat on, one injected NaN that must roll back to a
   bit-identical committed state; every committed loss finite and the
   last below the first; K2/K4 launches equal their calls, the remat
   recompute's included (2 per layer and step); step ms p50, tokens/s,
   the model-FLOP share of the bf16 peak, init and step peaks, and one
   profiled step's device-busy ms (its share taken of the step p50, since
   the profiler stretches the profiled step's wall time), K2/K4 kernel ms
   and plain backward ms; ``python -m repro_torch.launch.train --arch
   paper-agentic --steps 8`` runs as a subprocess once mamba2's profiled
   step has finished on the card, beside the host's processing of its
   trace;
14. (run before 10, after 13) tensor-parallel serving with both shards of
   a ``tp=2`` engine on cuda:0, so one card holds the shard-local math,
   the kernels at the shards' shapes and the sums between shards: (a) the
   hard gate, ``paper-agentic`` at 2 layers in f32 through the reference
   tp tests' cycle (decode, fork 2, 3 steps, a 4x4 verify, commit, a
   step) at tp 2 on the card, tp 1 on the card and tp 2 on the CPU, on
   the fused, ``"ref"`` and int8 paths (identical tokens, verify rows and
   CoW counts, verify logits within ``TP_F32_TOL``), then a reduced MoE
   config (identical expert ids at every routing call); (b)
   ``qwen2-1.5b`` at full width and depth in bf16 at tp 2 through phase
   3's load (fused, then 4 ``"ref"`` steps): prefill ms, step p50,
   tokens/s, busy share, 56 paged walks a step, the first step's logits
   within ``TP_BF16_REL_RMS`` of tp 1's; (c) ``qwen3-moe-235b-a22b`` at
   full width cut to ``TP_MOE_LAYERS`` layers at tp 2 (64 experts a
   shard) through phase 11's load: the expert-parallel block against one
   device on one input (identical ids, output within ``TOL``), the two
   shards' ids at the first routing call, step p50 and busy share; (d)
   ``dbrx-132b`` at full width cut to ``TP_DBRX_LAYERS`` layers at tp 4
   (12 heads over 2 kv heads and 4 experts a shard: the shapes its
   serving over four cards gives K1 and K2), its weights drawn shard by
   shard (``Model.init(generator, shards=plan)``) and held bit for bit
   against the whole init's slices, layer 0's MoE block over the 4
   shards against one device on one input, the engine given the placed
   shards through phase 11's load, its shards routing the first call's
   rows alike and as tp 1 does, and, at a capacity that drops no row, the
   first step's logits of the rows routed as tp 1 at every call within
   ``TP_BF16_REL_RMS`` of tp 1's;
15. training over a (data 2, model 2) mesh of cuda:0 named four times,
   the state stored as the mesh's blocks (``init_train_state`` over the
   plan): (a) the hard gate in f32 at ``reduced(granite-8b,
   d_model=128)``: three AdamW steps over the mesh against one device
   (the tolerances of
   ``tests/test_torch_train.py``), ``ring_allreduce`` exact,
   ``psum_quantized`` within ``max|x|/127 · n``, ``ElasticController``
   from 4 positions to 2, and the MoE block with ``dp_axes`` at
   qwen3-moe-235b-a22b's full width against one device (identical ids,
   ``y`` within ``TOL``, ``aux`` the data positions' mean); (b)
   ``qwen2-1.5b`` at full width and depth in bf16 at phase 13's b 4 × s
   2048 over the mesh through ``FaultTolerantTrainer`` (phase 13's gates:
   an injected NaN rolled back bit-identically, falling finite losses, K2
   launches equal to its calls, 2 per layer, position and step), its first
   step within bf16 tolerance of phase 13's, step p50, tokens/s and
   model-FLOP share beside phase 13's, the peaks, a profiled step's busy
   share; (c) ``launch.train --distributed`` as a subprocess (one card:
   single-device), started once (b)'s last step has finished on the
   card, beside the host's processing of (b)'s profiled trace; (d) the
   SSM families' hard gate in f32: reduced mamba2 and zamba2 at the SSD
   scan kernel's widths, three AdamW steps over (data 1, model 2) and
   (data 2, model 2) against one device at (a)'s tolerances, K4's and
   K2's launches equal to their calls; (e) ``mamba2-2.7b`` at full width
   and depth in bf16 at phase 13's b 2 × s 2048 over the mesh (40 SSD
   heads a model position), as (b), its profile the card's activity
   only: 512 K4 launches a step, the first step within (b)'s
   bf16 tolerance of phase 13's; (f) (b)'s state as stored blocks: its
   bytes per device, their sum equal to the whole tree's, no stored
   tensor larger than its block;
10. the timing of each kernel at the main paths' shapes beside its plain
   version, the nearest single PyTorch call where one exists, the card's
   bound and the time of each kernel's earlier design (from PERF.md: K2
   and K4 on the CUDA cores, K1 and K3 the CUDA-core page walk), and
   rows at phase 11's shapes (K1/K3 at stablelm-12b's decode, K2 at hd
   160 beside SDPA, K1 at nemotron-4-15b's g 6) and phase 12's (K2 at
   hd 112 beside SDPA, K1 at qwen3-moe-235b-a22b's g 16 decode) and
   phase 13's (K2 at b 4 × s 2048 and K4 at b 2 × s 2048: the kernel
   forward beside the plain forward, the plain recompute backward and, for
   K2, SDPA's forward + backward) and phase 14's per-shard shapes (K1
   and K3 at qwen2-1.5b's tp 2 decode, kv 1 and g 6; K2 at h 6 over kv 1
   beside SDPA; K1 at qwen3-moe-235b-a22b's tp 2 decode, kv 2 and g 16;
   dbrx-132b's tp 4 shard: K1 at its decode, kv 2 and g 6, and K2 at h 12
   over kv 2, s 1024, beside SDPA) and phase 15's per-position shape (K2
   at b 2 × s 2048, h 6 over kv 1:
   the kernel forward, the plain forward and recompute backward, SDPA's
   forward and forward + backward) and per-model-position shapes (b 1 ×
   s 2048: K4 at mamba2's H 40 and zamba2's H 56, N 64; K2 at zamba2's
   shared block, h 16 over kv 16 at hd 112, beside SDPA); then the
   ``{"kernels": [...]}`` line (K1-K4, launches summed over the main
   paths and phases 11, 12, 13, 15, 16 and 17, then the per-shard rows with
   phase 14's launches and the per-position and per-model-position rows
   with phase 15's), the card line and the final ``{"ok": true, ...}``
   line;
16. (run after 15, before 10) the examples' torch twins: (a)
   ``quickstart_torch.py``, ``agentic_serve_torch.py`` and
   ``speculative_train_torch.py`` in process inside one profiler window
   (their K1 and K2 launches counted and traced), ``train_100m_torch.py``
   at its full ~100M config for 30 steps, logged (and checkpointed) every
   15 (its loss falls), and
   ``agentic_serve_torch.py --client`` against ``python -m
   repro_torch.launch.serve --serve`` on the card; (b) ``python -m
   repro_torch.launch.profile_cell --device cuda`` on three cells cut to
   one card (qwen2-1.5b ``decode_32k`` at b 16, ``prefill_32k`` at b 1,
   mamba2-2.7b ``prefill_32k`` at b 1): the top kernels, the busy share,
   the step ms and the roofline share (the op counter's larger term over
   the step, at most 1.05);
17. (run after 16, before 10) serving over a plan (``Model(plan=).prefill``
   and ``decode_step``: the cache as blocks, the decode attention's
   partial softmax states merged across model positions), every position
   on cuda:0: the hard gate in f32 at reduced widths (a dense and an SSM
   config over (data 2, model 2), the card against the CPU: identical
   greedy tokens, logits within ``PLAN_F32_TOL``), then ``qwen2-1.5b`` at
   full width and depth over (data 2, model 2) and ``mamba2-2.7b`` at full
   width, cut in depth, over (data 1, model 2), bf16, b 4 × s 512 and 16
   greedy steps against one device's ``Model``: the prefill's logits
   within ``PLAN_BF16_REL_RMS``, K2's (K4's) launches equal to its calls.

Every path's kernel launch counters are zeroed just before it runs and
read just after; a kernel of the path that never launched fails the run.

It needs nothing but the checkout: no network, no weights on disk.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import io
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BW,
    PEAK_FLOPS_BF16,
    PEAK_FLOPS_F32,
)

# published H100 SXM peaks (NVIDIA data sheet, launch/mesh.py): HBM
# bytes/s, and dense operations/s by input type (f32 runs outside the
# tensor cores)
HBM_BYTES_PER_S = HBM_BW
PEAK_OPS_PER_S = {torch.bfloat16: PEAK_FLOPS_BF16,
                  torch.float32: PEAK_FLOPS_F32}

# (atol, rtol): |out - ref| <= atol + rtol * |ref| elementwise.  Both
# versions take the same inputs to f32, sum in f32 in different orders
# (~1e-6 apart) and round the result once to the output's type.  f32: the
# order noise only.  bf16: the two f32 sums can round to neighbouring bf16
# values, one ulp apart, and an ulp is at most 2**-7 of the value.
TOL = {torch.bfloat16: (2e-5, 2 ** -7), torch.float32: (2e-5, 0.0)}
# gradients are sums over the batch and sequence whose terms are as large
# as the largest gradient (dt's reach ~2000 while single elements cancel to
# ~0), so their order noise is held to 1e-5 of the leaf's largest
# magnitude, on top of TOL's relative term (one bf16 ulp)
GRAD_SCALE_TOL = 1e-5


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


def ptxas_report(log_text: str) -> list:
    """(kernel, registers, spill-store bytes) of each kernel in one ptxas
    -v log."""
    out, kernel, spill = [], None, 0
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif "Used " in ln and " registers" in ln and kernel:
            out.append((kernel, int(ln.split("Used ")[1].split()[0]), spill))
            kernel = None
    return out


def tensor_core_counts(lib: Path) -> dict:
    """wgmma (HGMMA) and mma.sync (HMMA) instructions in a built library's
    SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return {"HGMMA": sass.count("HGMMA"), "HMMA": sass.count("HMMA")}


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


def compare(out: torch.Tensor, ref: torch.Tensor, grad: bool = False
            ) -> dict:
    """Max abs error, mean |ref| and whether out is finite and within TOL
    of ref everywhere (a gradient: TOL's relative term and
    ``GRAD_SCALE_TOL`` of its largest magnitude)."""
    atol, rtol = TOL[ref.dtype]
    if grad:
        atol = GRAD_SCALE_TOL * ref.float().abs().max().item()
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    ok = bool(torch.isfinite(o).all()) and bool(
        (diff <= atol + rtol * r.abs()).all())
    return {"max_abs_err": diff.max().item(),
            "mean_abs_ref": r.abs().mean().item(), "ok": ok}


def tol_text(c: dict, dtype, grad: bool = False) -> str:
    atol, rtol = TOL[dtype]
    if grad:
        return (f"max_abs_err={c['max_abs_err']:.3g} (tol {rtol:.3g}*|ref| "
                f"+ {GRAD_SCALE_TOL:.0e}*max|ref|, mean |ref| "
                f"{c['mean_abs_ref']:.3g}) {'ok' if c['ok'] else 'MISMATCH'}")
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
    """(bytes, operations) this call must move and do
    (``paged_attention.ops.cost`` at the case's lengths)."""
    return paged_ops.cost(case["q"], case["k_pages"],
                          case["lengths"].tolist(),
                          quantized="k_scales" in case)


def bound_ms(nbytes: int, ops: int, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cached_case(case) -> dict:
    """Inputs of paged_attention from a t = 1 case of paged_chunk_attention:
    the decoded token is already in its slot, so each row's length counts
    it; no page_map, no inline chunk."""
    return {"q": case["q"][:, 0].contiguous(), "k_pages": case["k_pages"],
            "v_pages": case["v_pages"], "block_tables": case["block_tables"],
            "lengths": case["lengths"]}


def cached_cost(case) -> tuple:
    """(bytes, operations) of paged_attention
    (``paged_attention.ops.cached_cost`` at the case's lengths)."""
    return paged_ops.cached_cost(case["q"], case["k_pages"],
                                 case["lengths"].tolist())


def ragged_lengths(gen, b: int, longest: int) -> list:
    """b lengths: 0, 1, one full page and the longest first, the rest
    uniform in [1, longest]."""
    rest = torch.randint(1, longest + 1, (b - 4,), generator=gen,
                         device="cuda").tolist()
    return [0, 1, 16, longest] + rest


def ssd_case(gen, *, s, H=80, P=64, N=128, dtype=torch.bfloat16, b=1):
    """SSD scan inputs at the model's scales: x, B and C after the conv's
    SiLU, dt after softplus with init_mamba's dt_bias, A from its A_log."""
    import torch.nn.functional as F

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    dt_bias = torch.log(torch.expm1(torch.logspace(-3, -1, H, device="cuda")))
    return (F.silu(rand(b, s, H, P)).to(dtype),
            F.softplus(rand(b, s, H) + dt_bias),
            -torch.linspace(1.0, 16.0, H, device="cuda"),
            F.silu(rand(b, s, N)).to(dtype), F.silu(rand(b, s, N)).to(dtype))



# ms of the earlier bf16 designs at the main paths' shapes, cold L2
# (PERF.md's "earlier ms" column: chip_smoke.py on an NVIDIA H100 80GB HBM3
# at 700.00 W), printed beside this run's times: K2 and K4 with f32
# arithmetic on the CUDA cores, K1 and K3 the CUDA-core page walk (f32
# staging, a second combine launch when split)
CUDA_CORE_MS = {("flash_attention", 1023): 0.7961,
                ("flash_attention", 2048): 1.8470,
                ("ssd_scan", 1000): 0.4944, ("ssd_scan", 2048): 0.9770,
                ("ssd_scan", 3000): 1.4256, ("ssd_scan", 4096): 1.9406,
                ("paged_chunk_attention", "decode"): 0.0498,
                ("paged_chunk_attention", "decode_len1024"): 0.0538,
                ("paged_chunk_attention", "verify"): 0.0402,
                ("paged_chunk_attention", "suffix_prefill"): 0.1552,
                ("paged_attention", "decode"): 0.0463,
                ("paged_attention", "decode_len1024"): 0.0520}


def ssd_cost(x, B) -> tuple:
    """(bytes, operations) of the SSD scan (``ssd_scan.ops.cost``)."""
    return ssd_ops.cost(x, B)


def flash_case(gen, *, s, h=12, kv=2, hd=128, dtype=torch.bfloat16):
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rand(1, s, h, hd), rand(1, s, kv, hd), rand(1, s, kv, hd)


def flash_cost(q, k) -> tuple:
    """(bytes, operations) of flash attention (``flash_attention.ops.cost``)."""
    return flash_ops.cost(q, k)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernels(gen) -> None:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_chunk_attention)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_chunk_attention_ref)
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    log("== phase 2: kernels against their plain versions")
    # t=8 at g=6 is speculative_decode's verify (48 query rows per kv
    # head); page 8 is the serving CLI's (a bf16 16-key tile spans two
    # pages there)
    k1_cases = [(16, hd, g, t, dtype, quant, [0, 700, 333])
                for hd, g in ((32, 2), (128, 6)) for t in (1, 4, 8, 300)
                for dtype, quant in ((torch.float32, False),
                                     (torch.bfloat16, False),
                                     (torch.bfloat16, True),
                                     (torch.float32, True))]
    k1_cases += [(8, hd, g, t, dtype, False, [0, 701, 8, 37])
                 for hd, g in ((32, 2), (128, 6)) for t in (1, 8)
                 for dtype in (torch.float32, torch.bfloat16)]
    # page 4 is the front door's parity geometry (a 16-key tile spans four
    # pages): decode, a verify of 4 and a 37-token suffix prefill
    k1_cases += [(4, hd, g, t, dtype, False, [0, 701, 4, 37])
                 for hd, g in ((32, 2), (128, 6)) for t in (1, 4, 37)
                 for dtype in (torch.float32, torch.bfloat16)]
    # stablelm-12b's head (hd 160, g 4): decode, a verify of 4 and a
    # 255-token suffix prefill, f32, bf16 and int8 pools, pages 16 and 4
    k1_cases += [(page, 160, 4, t, dtype, quant, lengths)
                 for page, lengths in ((16, [0, 700, 333]),
                                       (4, [0, 701, 4, 37]))
                 for t in (1, 4, 255)
                 for dtype, quant in ((torch.float32, False),
                                      (torch.bfloat16, False),
                                      (torch.bfloat16, True))]
    # qwen3-moe-235b-a22b's head (g 16, hd 128: 16 query rows per kv head
    # at decode, 64 at a verify of 4): decode, verify and a 255-token suffix
    # prefill, f32, bf16 and int8 pools, pages 16 and 4
    k1_cases += [(page, 128, 16, t, dtype, quant, lengths)
                 for page, lengths in ((16, [0, 700, 333]),
                                       (4, [0, 701, 4, 37]))
                 for t in (1, 4, 255)
                 for dtype, quant in ((torch.float32, False),
                                      (torch.bfloat16, False),
                                      (torch.bfloat16, True))]
    for page, hd, g, t, dtype, quant, lengths in k1_cases:
        case = paged_case(gen, b=len(lengths), t=t, kv=2, g=g, hd=hd,
                          page=page, lengths=lengths, dtype=dtype,
                          quant=quant, cow=True)
        out = paged_chunk_attention(**case)
        torch.cuda.synchronize()
        c = compare(out, paged_chunk_attention_ref(**case))
        log(f"K1 paged_chunk_attention page={page} hd={hd} g={g} t={t} "
            f"{str(dtype)[6:]}{' int8-pool' if quant else ''} "
            f"cow+zero-length {tol_text(c, dtype)}")
        if not c["ok"]:
            fail("paged_chunk_attention disagrees with its plain version")
    # qwen2-1.5b's prefill (h 12, kv 2, hd 128), stablelm-12b's (h 32, kv
    # 8, hd 160), musicgen-medium's MHA (h 24 = kv, hd 64, g 1), zamba2-7b's
    # shared block (h 32 = kv, hd 112: staged as 128), qwen3-moe-235b-a22b's
    # (h 64, kv 4: g 16) and dbrx-132b's (h 48, kv 8)
    for s in (1023, 2048):
        for h, kv, hd in ((12, 2, 128), (32, 8, 160), (24, 24, 64),
                          (32, 32, 112), (64, 4, 128), (48, 8, 128)):
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = flash_case(gen, s=s, h=h, kv=kv, hd=hd,
                                     dtype=dtype)
                out = flash_attention(q, k, v)
                torch.cuda.synchronize()
                c = compare(out, flash_attention_ref(q, k, v))
                log(f"K2 flash_attention h={h} kv={kv} hd={hd} s={s} "
                    f"{str(dtype)[6:]} {tol_text(c, dtype)}")
                if not c["ok"]:
                    fail("flash_attention disagrees with its plain version")
    for page, dtype, hd, g in ((16, torch.bfloat16, 128, 6),
                               (16, torch.float32, 128, 6),
                               (4, torch.bfloat16, 128, 6),
                               (4, torch.float32, 128, 6),
                               (16, torch.bfloat16, 160, 4),
                               (16, torch.float32, 160, 4)):
        lengths = ragged_lengths(gen, 32, 1055)
        case = cached_case(paged_case(gen, b=32, t=1, kv=2, g=g, hd=hd,
                                      page=page, lengths=lengths,
                                      dtype=dtype))
        out = paged_attention(**case)
        torch.cuda.synchronize()
        c = compare(out, paged_attention_ref(**case))
        zero = not out[0].any()
        log(f"K3 paged_attention page={page} b=32 kv=2 g={g} hd={hd} "
            f"lengths 0..1055 {str(dtype)[6:]} {tol_text(c, dtype)}, "
            f"zero-length row 0: {zero}")
        if not c["ok"] or not zero:
            fail("paged_attention disagrees with its plain version")
    bf16, f32 = torch.bfloat16, torch.float32
    for N, s, dtype in ((128, 1000, bf16), (128, 1000, f32), (128, 4096, bf16),
                        (128, 4096, f32), (64, 1000, bf16), (64, 4096, f32)):
        args = ssd_case(gen, s=s, N=N, dtype=dtype)
        y, state = ssd_scan(*args)
        torch.cuda.synchronize()
        y_ref, state_ref = ssd_scan_ref(*args)
        cy, cs = compare(y, y_ref), compare(state, state_ref)
        log(f"K4 ssd_scan H=80 P=64 N={N} s={s} {str(dtype)[6:]}: y "
            f"{tol_text(cy, dtype)}; state {tol_text(cs, torch.float32)}")
        if not (cy["ok"] and cs["ok"]):
            fail("ssd_scan disagrees with its plain version")
    kernel_grads(gen)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    return {**paged_ops.LAUNCHES, **flash_ops.LAUNCHES, **ssd_ops.LAUNCHES}


def zero_launches() -> None:
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    for counts in (paged_ops.LAUNCHES, flash_ops.LAUNCHES, ssd_ops.LAUNCHES):
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def counted_calls():
    """Count the engine's calls of the two paged-attention wrappers and the
    prefills' calls of flash attention (the engine's dense prefill and the
    model's: the names serve_loop and the decode module bound at import),
    to hold launches to one per call."""
    from repro_torch.models import decode
    from repro_torch.runtime import serve_loop

    sites = (("paged_chunk_attention", serve_loop),
             ("paged_attention", serve_loop),
             ("flash_attention", serve_loop), ("flash_attention", decode))
    calls = {name: 0 for name, _ in sites}
    saved = [(name, mod, getattr(mod, name)) for name, mod in sites]

    def counting(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call
    for name, mod, fn in saved:
        setattr(mod, name, counting(name, fn))
    try:
        yield calls
    finally:
        for name, mod, fn in saved:
            setattr(mod, name, fn)


def launches_match_calls(launches: dict, calls: dict) -> None:
    """Every bf16 call of an attention wrapper was one kernel launch."""
    for name, n in calls.items():
        if launches[name] != n:
            fail(f"{name}: {launches[name]} launches for {n} bf16 calls "
                 "(one launch per call expected)")


#: phase 3's prompt lengths: 8 requests, 4 branches each (b = 32)
DENSE_PROMPTS = (1024, 768, 128, 256, 384, 512, 640, 896)


def dense_prompts(cfg, lens, rng) -> list:
    """Phase 3's prompts of ``lens`` tokens drawn from ``rng``; the second
    shares its first 512 tokens with the first."""
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    prompts[1][:512] = prompts[0][:512]        # a shared 512-token head
    return prompts


def serve_dense(model, params, *, attn_impl: str, steps: int,
                lens=DENSE_PROMPTS, seed: int = 0,
                tp: int | None = None) -> dict:
    """One run of a dense load through ServeEngine (phase 3; phase 11 with
    4 prompts): page 16, prefix cache on; the second prompt shares 512
    tokens with the first, so one suffix prefill runs through K1; 4
    lazy-CoW branches per prompt, ``steps`` decode steps on the fused path
    (attn_impl="auto") or path B ("ref"), a 4x4 verify, first-commit-wins,
    a checkpoint/restore, a release back to a full pool.  The engine's
    paged-attention and the prefill's flash-attention calls are counted: every bf16 call must be one launch.  Each profiled decode
    step must launch the paged walk once per layer by the wrappers'
    counters, the tracer must see every one of those launches run on the
    card (a window that lost events is traced again), and no split combine
    kernel may run.  With ``tp`` the engine runs ``tp`` shards on
    cuda:0 (phase 14), each layer's walk once per shard; ``params`` is the
    whole tree or one tree per shard already placed there."""
    from repro_torch.runtime import ServeEngine

    cfg = model.cfg
    legacy = attn_impl == "ref"
    eng = ServeEngine(model, params, page_size=16, num_pages=2048,
                      max_pages_per_seq=128, prefix_cache=True,
                      attn_impl=attn_impl, tp=tp,
                      device="cuda:0" if tp else None)
    rng = np.random.default_rng(seed)
    prompts = dense_prompts(cfg, lens, rng)

    zero_launches()
    with counted_calls() as calls:
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
            fail(f"{cfg.name}: expected {len(prompts)} prefills, got {st}")
        branches = {r: eng.fork(r, 4) for r in roots}
        batch = [b for r in roots for b in branches[r]]
        n = len(batch)
        step_ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            out = eng.decode(batch)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if len(out) != n or not all(0 <= x < cfg.vocab_size
                                        for x in out):
                fail(f"{cfg.name}: bad decode output {out}")
        faults = (eng.cow_faults, eng.cow_dispatches, eng.cow_inline_steps)
        if faults != ((n, 1, 0) if legacy else (n, 0, 1)):
            fail(f"{cfg.name}: expected {n} CoW faults serviced "
                 f"{'as one dispatch' if legacy else 'inline in one step'}"
                 f": {eng.stats()}")
        # the lengths the last timed step's attention read: the cached
        # prefix (K1, token inline) or the prefix and the token (K3)
        decode_lengths = [eng.kv.length(x) - (0 if legacy else 1)
                          for x in batch]
        profile = profile_steps(lambda: eng.decode(batch))
        probe = branches[roots[0]][0]
        verify_length = eng.kv.length(probe)
        drafts = [rng.integers(0, cfg.vocab_size, 4).tolist()
                  for _ in range(4)]
        rows = eng.spec_verify(probe, drafts)
        if len(rows) != 4 or any(len(r) != 4 for r in rows):
            fail(f"{cfg.name}: bad spec_verify rows {rows}")
        for r in roots:
            eng.commit(branches[r][0])
        if eng.stats()["sequences_live"] != len(roots):
            fail(f"{cfg.name}: siblings survived first-commit-wins: "
                 f"{eng.stats()}")
        before = eng.spec_verify(roots[2], [[1, 2, 3]])
        freed = eng.checkpoint(roots[2])
        eng.restore(roots[2])
        after = eng.spec_verify(roots[2], [[1, 2, 3]])
        if before != after or not freed:
            fail(f"{cfg.name}: checkpoint/restore changed the branch: "
                 f"{before} {after}")
        final = eng.decode(roots)
        torch.cuda.synchronize()
    launches = launch_counts()
    for r in roots:
        eng.release(r)
    st = eng.stats()
    log(f"after release: {st}")
    if (st["sequences_live"] or st["pages_free"] + st["prefix_pages_cached"]
            != st["pages_total"]):
        fail("pool not drained back to full (free + prefix-cached pages)")
    log(f"attention calls on the path: {calls}; launches: {launches}")
    if not legacy and calls["paged_attention"]:
        fail(f"the fused path called the legacy kernel: {calls}")
    needed = ["paged_chunk_attention", "flash_attention"]
    needed += ["paged_attention"] if legacy else []
    if not all(launches[k] for k in needed):
        fail(f"a kernel of the path never launched: {launches}")
    launches_match_calls(launches, calls)
    walk_gate(profile, cfg.num_layers * eng.tp)
    decode_p50 = statistics.median(step_ms)
    busy = (None if profile.get("idle_share") is None
            else round(1 - profile["idle_share"], 3))
    card = card_line()
    name = cfg.name + (f" tp {eng.tp}" if tp else "")
    log(f"{name} prefill ms per request (prompt {list(lens)}, the "
        f"second's first 512 tokens cached): "
        f"{[round(x, 3) for x in prefill_ms]} ({card})")
    log(f"{name} decode step ms p50 {decode_p50:.3f} (b={n}, {steps} "
        f"steps, attn_impl={attn_impl!r}), {n / decode_p50 * 1e3:.1f} "
        f"tokens/s, device busy share {busy} ({card})")
    return {
        "prefill_ms": [round(x, 3) for x in prefill_ms],
        "suffix_prefill_ms": round(prefill_ms[1], 3),
        "decode_step_ms_p50": round(decode_p50, 3),
        "decode_tokens_per_s": round(n / decode_p50 * 1e3, 1),
        "device_busy_share": busy,
        "final_tokens": final,
        "launches": launches,
        "decode_lengths": decode_lengths,
        "verify_length": verify_length,
        "profile": profile,
    }


def phase_dense(seed: int = 0) -> tuple:
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    log("== phase 3: dense path, qwen2-1.5b bf16, random weights")
    cfg = get_config("qwen2-1.5b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"init {n_params / 1e9:.3f} B params in "
        f"{time.perf_counter() - t0:.1f} s")
    fused = serve_dense(model, params, attn_impl="auto", steps=32, seed=seed)
    log("-- path B: the same load on the legacy attn_impl='ref' path")
    legacy = serve_dense(model, params, attn_impl="ref", steps=8, seed=seed)
    del params
    torch.cuda.empty_cache()
    return fused, legacy


def ssm_cycle(model, params, prompts, *, n_branches: int, steps: int,
              device: str, timed: bool = False,
              max_len: int | None = None) -> dict:
    """The JAX package's SSM and hybrid serving path (DESIGN §6), which has
    no engine: each prompt is prefilled (through the SSD scan; the hybrid's
    shared block through flash attention, into a ``max_len`` KV cache) and
    its cache snapshotted into ROOT of its own BranchStore; ROOT forks
    n_branches whose first tokens are the prefill's best n; every step
    decodes all branches of all requests as one batch (their [L, 1, ...]
    leaves concatenated on the batch dim into new tensors, which the
    hybrid's step writes its K/V rows into) and writes each slice back to
    its branch as a tensor of its own; then per request the branch with
    the highest mean log-probability commits, its siblings must read as
    stale, and all are reaped."""
    from repro_torch.core import BranchStore, StaleBranchError

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stores, prefill_ms, first = [], [], []
    for p in prompts:
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params,
                                      torch.tensor([p], device=device),
                                      max_len=max_len)
        sync()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        store = BranchStore()
        store.snapshot_pytree(store.ROOT, cache)
        stores.append(store)
        first.append(torch.log_softmax(logits[0, -1].float(), dim=-1)
                     .topk(n_branches))
        template = dict.fromkeys(cache, 0)   # the cache's leaves, by name
        del logits, cache
    sync()
    mem_before = torch.cuda.memory_allocated() if cuda else 0
    branches, toks, score = [], [], []
    for r, store in enumerate(stores):
        kids = store.fork(store.ROOT, n_branches)
        for kid, t, lp in zip(kids, first[r].indices.tolist(),
                              first[r].values.tolist()):
            branches.append((r, store, kid))
            toks.append([t])
            score.append(lp)
    del first
    pos = [len(prompts[r]) for r, _, _ in branches]

    def step() -> None:
        if max_len is not None and max(pos) >= max_len:
            fail(f"position {max(pos)} past the {max_len}-position cache")
        caches = [store.restore_pytree(kid, template)
                  for _, store, kid in branches]
        batch = {n: torch.cat([c[n] for c in caches], dim=1)
                 for n in template}
        del caches
        logits, new = model.decode_step(
            params, batch, torch.tensor([[t[-1]] for t in toks],
                                        device=device),
            torch.tensor(pos, device=device))
        del batch
        best = torch.log_softmax(logits[:, -1].float(), dim=-1).max(dim=-1)
        for i, (_, store, kid) in enumerate(branches):
            # a tensor of its own: a view would keep the whole batch alive
            # and alias the siblings
            store.write_many(kid, store.flatten_pytree(
                {n: v[:, i:i + 1].clone() for n, v in new.items()}))
        for i, (t, lp) in enumerate(zip(best.indices.tolist(),
                                        best.values.tolist())):
            toks[i].append(t)
            score[i] += lp
            pos[i] += 1

    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()                        # .tolist() synced the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    profile = profile_steps(step) if timed else None
    winners = []
    for r, store in enumerate(stores):
        mine = [i for i, b in enumerate(branches) if b[0] == r]
        w = max(mine, key=lambda i: score[i] / len(toks[i]))
        store.commit(branches[w][2])
        winners.append(w)
        for i in mine:
            if i != w:
                try:
                    store.read(branches[i][2], "['ssm']")
                    fail(f"branch {branches[i][2]} read after its sibling "
                         "committed")
                except StaleBranchError:
                    pass
            store.reap(branches[i][2])
    sync()
    return {
        "prefill_ms": prefill_ms, "step_ms": step_ms, "profile": profile,
        "tokens": toks, "winners": winners,
        "states": [store.restore_pytree(store.ROOT, template)
                   for store in stores],
        "mem_before": mem_before,
        "mem_after": torch.cuda.memory_allocated() if cuda else 0,
    }


def phase_ssm(seed: int = 0) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    log("== phase 4: path A, mamba2-2.7b bf16, random weights, 4 requests "
        "x 8 branches")
    cfg = get_config("mamba2-2.7b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"init {n_params / 1e9:.3f} B params "
        f"({sum(p.nbytes for p in _leaves(params)) / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    lens = [1000, 2048, 3000, 4096]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    zero_launches()
    res = ssm_cycle(model, params, prompts, n_branches=8, steps=32,
                    device="cuda", timed=True)
    launches = launch_counts()
    log(f"launches on the path: {launches}")
    if launches["ssd_scan"] != cfg.num_layers * len(prompts):
        fail(f"expected {cfg.num_layers} ssd_scan launches per prefill: "
             f"{launches}")
    drift = abs(res["mem_after"] - res["mem_before"]) / res["mem_before"]
    log(f"device memory before the fork {res['mem_before'] / 1e9:.3f} GB, "
        f"after commit and reap {res['mem_after'] / 1e9:.3f} GB "
        f"({drift:.2%} apart)")
    if drift > 0.05:
        fail("the reaped branches' states were not released")
    for toks in res["tokens"]:
        # the prefill's token, 32 timed steps, 3 under the profiler
        if len(toks) != 36 or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"bad branch tokens {toks}")
    for state in res["states"]:
        if not all(torch.isfinite(v).all() for v in state.values()):
            fail("the committed state is not finite")
    p50 = statistics.median(res["step_ms"])
    card = card_line()
    log(f"prefill ms per request (prompt {lens}): "
        f"{[round(x, 3) for x in res['prefill_ms']]} ({card})")
    log(f"decode step ms p50 {p50:.3f} (b=32: 4 requests x 8 branches, "
        f"32 steps), {32 / p50 * 1e3:.1f} tokens/s ({card})")
    log(f"winners {res['winners']}")
    del params, res["states"]
    torch.cuda.empty_cache()
    return {"prefill_ms": [round(x, 3) for x in res["prefill_ms"]],
            "decode_step_ms_p50": round(p50, 3),
            "decode_tokens_per_s": round(32 / p50 * 1e3, 1),
            "launches": launches, "prefill_lengths": lens,
            "profile": res["profile"]}


#: the paged walk's kernels (K1 and K3, bf16 on tensor cores or f32 on the
#: CUDA cores), by the names the tracer gives them; the split combine is not
#: one of them
WALK_KERNELS = ("paged_tc_kernel", "paged_chunk_attention_kernel",
                "paged_attention_kernel")


def profile_steps(step, steps: int = 2, attempts: int = 4) -> dict:
    """Device time by kernel and the idle share over a few steps
    (torch.profiler; host wall clock around the steps, which sync).  One
    more step runs first as the profiler's warm-up, traced and dropped:
    events of a window's first kernels can be lost while the tracer
    starts (a run on an H100 lost ~112 of 4240).  A window can still lose
    a burst of events later (one lost a layer's worth of every kernel), so
    the paged walks the tracer saw are held against the wrappers' counters
    over the same steps: a window that lost any is traced again, up to
    ``attempts`` windows.  ``complete`` is True when the tracer saw every
    counted walk, None when the steps launched none (nothing to check)."""
    for attempt in range(attempts):
        out = _profile_window(step, steps)
        if out["complete"] is not False:
            return out
        log(f"profile window {attempt + 1} of {attempts} lost events: the "
            f"tracer saw {out['walk_traced']} of {out['walk_counted']} "
            "paged walks")
    return out


def _profile_window(step, steps: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def walks() -> int:
        n = launch_counts()
        return n["paged_chunk_attention"] + n["paged_attention"]

    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps),
                 on_trace_ready=lambda p: traced.append(
                     p.key_averages())) as prof:
        step()
        prof.step()
        walks0 = walks()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
            # before the last prof.step(), which collects the trace
            wall_us = (time.perf_counter() - t0) * 1e6
            counted = walks() - walks0
            prof.step()
    kernels = []
    for e in traced[0]:
        # the schedule's step ranges are annotations, not kernels
        if (e.device_type != DeviceType.CUDA
                or e.key.startswith("ProfilerStep")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us, e.count, e.key))
    seen = sum(k[1] for k in kernels if any(w in k[2] for w in WALK_KERNELS))
    out = {"walk_counted": counted, "walk_traced": seen,
           "complete": None if not counted else seen == counted,
           "walk_launches_per_step": counted / steps}
    busy = sum(k[0] for k in kernels)
    if not busy:
        log("profile: device time not measured (no CUDA events)")
        return {**out, "device_busy_ms_per_step": None, "idle_share": None}
    kernels.sort(reverse=True)
    log(f"profile over {steps} steps: wall {wall_us / steps / 1e3:.3f}"
        f" ms/step, device busy {busy / steps / 1e3:.3f} ms/step, idle "
        f"{1 - busy / wall_us:.3f}, {sum(k[1] for k in kernels) // steps} "
        f"kernels/step; paged walks traced {seen} of {counted} launched")
    for us, count, name in kernels[:8]:
        log(f"  {us / steps / 1e3:8.3f} ms/step {count // steps:5d}x "
            f"{name[:90]}")
    out.update(device_busy_ms_per_step=busy / steps / 1e3,
               idle_share=1 - busy / wall_us)
    for label, key, name in (
            ("K1/K3 attention (bf16, tensor cores)", "paged_tc_kernel",
             "paged"),
            ("K1 attention (f32)", "paged_chunk_attention_kernel", None),
            ("K3 attention (f32)", "paged_attention_kernel", None),
            ("K1/K3 split combine (f32)", "paged_chunk_combine_kernel",
             "combine")):
        mine = [k for k in kernels if key in k[2]]
        ms = sum(k[0] for k in mine) / steps / 1e3
        n = sum(k[1] for k in mine) // steps
        if mine:
            log(f"  {label}: {ms:.3f} ms/step, {n} launches/step")
        if name:
            out[f"{name}_ms_per_step"] = ms
            out[f"{name}_launches_per_step"] = n
    return out


def walk_gate(profile: dict, num_layers: int) -> None:
    """A profiled bf16 decode step launched the paged walk once per layer
    (the wrappers' counters), the tracer saw each of those launches run on
    the card in a window that lost none, and no split combine kernel ran
    there."""
    if profile["walk_launches_per_step"] != num_layers:
        fail(f"expected {num_layers} paged-walk launches per profiled "
             f"decode step (one per layer), counted "
             f"{profile['walk_launches_per_step']}")
    if not profile["complete"]:
        fail("every profile window lost paged-walk events (the tracer saw "
             f"{profile['walk_traced']} of {profile['walk_counted']})")
    if profile["combine_launches_per_step"]:
        fail(f"a split combine kernel ran in the bf16 profile: {profile}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


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

    log("== phase 5: parity in float32, card (kernels) vs CPU (plain)")
    # full float32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = {}
    for dev, kv_dtype, impl in (("cpu", None, "auto"), ("cuda", None, "auto"),
                                ("cuda", None, "ref"), ("cpu", "int8", "auto"),
                                ("cuda", "int8", "auto")):
        eng = ServeEngine(model, params, num_pages=128, page_size=4,
                          max_pages_per_seq=16, kv_dtype=kv_dtype,
                          attn_impl=impl, device=dev)
        tokens[dev, kv_dtype, impl] = exercise(eng)
    for key in (("cuda", None, "auto"), ("cuda", None, "ref"),
                ("cuda", "int8", "auto")):
        want = tokens["cpu", key[1], "auto"]
        same = tokens[key] == want
        log(f"paper-agentic {key[0]} kv_dtype={key[1]} attn_impl={key[2]!r} "
            f"vs cpu fused: greedy tokens identical={same} ({len(want)} "
            "tokens)")
        if not same:
            fail(f"{key}: {tokens[key]} != cpu {want}")

    # a paper-agentic-sized engine at stablelm-12b's head dim (hd 160)
    cfg = dataclasses.replace(get_config("paper-agentic"), d_model=640,
                              num_heads=4, num_kv_heads=2, head_dim=160,
                              num_layers=2, dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = {}
    for dev, impl in (("cpu", "auto"), ("cuda", "auto"), ("cuda", "ref")):
        eng = ServeEngine(model, params, num_pages=128, page_size=4,
                          max_pages_per_seq=16, attn_impl=impl, device=dev)
        tokens[dev, impl] = exercise(eng)
    for key in (("cuda", "auto"), ("cuda", "ref")):
        same = tokens[key] == tokens["cpu", "auto"]
        log(f"hd 160 engine (d 640, 4 heads of 160, kv 2, 2 layers) "
            f"{key[0]} attn_impl={key[1]!r} vs cpu fused: greedy tokens "
            f"identical={same} ({len(tokens[key])} tokens)")
        if not same:
            fail(f"hd 160 {key}: {tokens[key]} != cpu "
                 f"{tokens['cpu', 'auto']}")
    for name, extra in (("musicgen-medium", {}),
                        ("pixtral-12b", {"patches": 16})):
        cfg = dataclasses.replace(get_config(name), num_layers=2,
                                  dtype="float32")
        model = Model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        runs = {dev: contiguous_run(model, _to(params, dev), b=2, s=40,
                                    steps=8, device=dev, **extra)["tokens"]
                for dev in ("cpu", "cuda")}
        same = runs["cuda"] == runs["cpu"]
        log(f"{name} widths, 2 layers, Model.prefill + 8 contiguous "
            f"decode_steps{' (16-patch frontend_embed)' if extra else ''}"
            f": greedy tokens identical={same}")
        if not same:
            fail(f"{name}: card {runs['cuda']} != cpu {runs['cpu']}")
        del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("mamba2-2.7b"), dtype="float32",
                              num_layers=4)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 300)
    runs = {dev: ssm_cycle(model, _to(params, dev), [prompt.tolist()],
                           n_branches=4, steps=4, device=dev)
            for dev in ("cpu", "cuda")}
    same = runs["cuda"]["tokens"] == runs["cpu"]["tokens"]
    errs = {n: (runs["cuda"]["states"][0][n].cpu()
                - runs["cpu"]["states"][0][n]).abs().max().item()
            for n in ("conv", "ssm")}
    log(f"mamba2-2.7b widths, 4 layers, 4 branches x 4 steps: tokens "
        f"identical={same}, winner {runs['cuda']['winners']} vs "
        f"{runs['cpu']['winners']}, committed state max |cuda - cpu| "
        f"{errs} (tol 1e-4)")
    if not same or runs["cuda"]["winners"] != runs["cpu"]["winners"]:
        fail(f"card {runs['cuda']['tokens']} != cpu {runs['cpu']['tokens']}")
    if max(errs.values()) > 1e-4:
        fail("the committed SSM state differs between card and CPU")
    hybrid_parity()
    moe_parity()
    train_parity()

    cfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    runs = {dev: session_parity_run(model, params, dev)
            for dev in ("cpu", "cuda")}
    log(f"paper-agentic through BranchSession (greedy fork/commit/finish, "
        f"one speculative_decode round): tokens identical="
        f"{runs['cuda'][:2] == runs['cpu'][:2]}, verified prefixes "
        f"{runs['cuda'][2]} vs {runs['cpu'][2]}")
    if runs["cuda"] != runs["cpu"]:
        fail(f"session run: card {runs['cuda']} != cpu {runs['cpu']}")

    runs = {dev: asyncio.run(front_door_parity_run(model, params, dev))
            for dev in ("cpu", "cuda")}
    gen_same = runs["cuda"]["generate"] == runs["cpu"]["generate"]
    log(f"paper-agentic through FrontDoor.dispatch (page 4): greedy "
        f"/v1/generate events identical={gen_same} "
        f"({[e for e, _ in runs['cuda']['generate']]}); /v1/explore "
        f"best_of_n: card {runs['cuda']['explore']}, cpu "
        f"{runs['cpu']['explore']}")
    if not gen_same:
        fail(f"front door: card {runs['cuda']['generate']} != cpu "
             f"{runs['cpu']['generate']}")
    for dev, run in runs.items():
        if run["explore"] != {"status": 200, "event": "result",
                              "committed": True, "commits": 1,
                              "drained": True}:
            fail(f"front door /v1/explore on {dev}: {run['explore']}")


def hybrid_parity() -> None:
    """zamba2-7b's widths at 7 layers (one shared-block application, then
    a one-layer tail), float32: the branching cycle on the card (K4, K2 at
    hd 112) and on the CPU from one set of weights; identical tokens and
    winner, the committed state (conv, ssm and the shared block's K/V)
    within 1e-4 + 1e-4 |cpu|."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config("zamba2-7b"), num_layers=7,
                              dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 200)
    runs = {dev: ssm_cycle(model, _to(params, dev), [prompt.tolist()],
                           n_branches=4, steps=4, device=dev, max_len=208)
            for dev in ("cpu", "cuda")}
    same = runs["cuda"]["tokens"] == runs["cpu"]["tokens"]
    cpu, card = runs["cpu"]["states"][0], runs["cuda"]["states"][0]
    errs = {n: (card[n].cpu() - cpu[n]).abs().max().item() for n in cpu}
    close = all(torch.allclose(card[n].cpu(), cpu[n], atol=1e-4, rtol=1e-4)
                for n in cpu)
    log(f"zamba2-7b widths, 7 layers (one shared application, a one-layer "
        f"tail), 4 branches x 4 steps: tokens identical={same}, winner "
        f"{runs['cuda']['winners']} vs {runs['cpu']['winners']}, committed "
        f"state max |cuda - cpu| {errs} (tol 1e-4 + 1e-4 |cpu|)")
    if not same or runs["cuda"]["winners"] != runs["cpu"]["winners"]:
        fail(f"hybrid: card {runs['cuda']['tokens']} != cpu "
             f"{runs['cpu']['tokens']}")
    if not close:
        fail("the committed hybrid state differs between card and CPU")
    del params, runs
    torch.cuda.empty_cache()


@contextlib.contextmanager
def routed_experts(limit: int | None = None):
    """Record the expert ids the MoE router picks (``[n, K]`` per call;
    only the first ``limit`` calls, so later steps run unsynced)."""
    from repro_torch.models import moe

    real, ids = moe.route, []

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        if limit is None or len(ids) < limit:
            ids.append(out[2].tolist())
        return out
    moe.route = recording
    try:
        yield ids
    finally:
        moe.route = real


def moe_parity() -> None:
    """qwen3-moe-235b-a22b's and dbrx-132b's widths at 2 layers, float32,
    through the engine: the card's fused and ``"ref"`` paths against the
    CPU's fused one, from one set of weights; identical greedy tokens and
    identical expert ids at every routing call (capacity drops included)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime import ServeEngine

    for name in ("qwen3-moe-235b-a22b", "dbrx-132b"):
        cfg = dataclasses.replace(get_config(name), num_layers=2,
                                  dtype="float32")
        model = Model(cfg)
        params = {"cuda": model.init(
            torch.Generator(device="cuda").manual_seed(0))}
        params["cpu"] = _to(params["cuda"], "cpu")
        tokens, experts = {}, {}
        for dev, impl in (("cpu", "auto"), ("cuda", "auto"),
                          ("cuda", "ref")):
            with routed_experts() as ids:
                eng = ServeEngine(model, params[dev], num_pages=128,
                                  page_size=4, max_pages_per_seq=16,
                                  attn_impl=impl, device=dev)
                tokens[dev, impl] = exercise(eng)
            experts[dev, impl] = ids
            del eng
        for key in (("cuda", "auto"), ("cuda", "ref")):
            same = tokens[key] == tokens["cpu", "auto"]
            routed = experts[key] == experts["cpu", "auto"]
            log(f"{name} widths, 2 layers, {key[0]} attn_impl={key[1]!r} vs "
                f"cpu fused: greedy tokens identical={same} "
                f"({len(tokens[key])} tokens), expert ids identical="
                f"{routed} ({len(experts[key])} routing calls)")
            if not same or not routed:
                fail(f"{name} {key}: tokens {tokens[key]} vs cpu "
                     f"{tokens['cpu', 'auto']}, expert ids identical "
                     f"{routed}")
        del params
        torch.cuda.empty_cache()


def session_parity_run(model, params, device: str) -> tuple:
    """The public API greedy on ``device``: a held root forked 3 ways, the
    children resumed greedy, one committed, the root resumed to its
    budget; then one ``speculative_decode`` round at temperature 1e-6 (the
    Gumbel draw cannot move the argmax there, so the drafts are the greedy
    continuation on either device).  Returns the tokens, the round's
    tokens and its verified prefixes."""
    from repro_torch.api import BR_HOLD, EV_FINISHED, BranchSession
    from repro_torch.explore_ctx import ExplorationDriver, speculative_decode
    from repro_torch.runtime import ServeEngine

    eng = ServeEngine(model, params, num_pages=128, page_size=4,
                      max_pages_per_seq=16, device=device)
    s = BranchSession(eng, max_batch=8, seed=1)
    root = s.open([5, 17, 3, 42, 7, 11, 2, 9, 30, 4, 8, 1, 22], 12, BR_HOLD)
    kids = s.branch(root, BR_HOLD, 3)
    for k in kids:
        s.resume(k, greedy=True)
    s.wait(kids, produced=4, require_all=True)
    s.commit(kids[1])
    s.resume(root, greedy=True)
    s.wait([root], events=EV_FINISHED)
    tokens = s.finish(root)
    res = ExplorationDriver(s).explore(
        [9, 8, 7, 6, 5], 12, speculative_decode, n_drafts=3, draft_tokens=8,
        temperature=1e-6).run()
    view = s.tree()
    if view["handles"]["open"] or view["pool"]["pages_free"] != \
            view["pool"]["pages_total"]:
        fail(f"the session did not drain on {device}: {view}")
    return tokens, res.tokens, res.stats["verified_per_draft"]


async def front_door_parity_run(model, params, device: str) -> dict:
    """The front door in process on ``device`` (the reference's server
    geometry: page 4, 128 pages, 16 per sequence, ``BranchSession(max_batch
    =8, seed=11)``): a streamed greedy ``/v1/generate`` (every event), then
    a ``/v1/explore`` best_of_n, which must commit exactly one winner and
    leave the pool drained."""
    from repro_torch.api import BranchSession
    from repro_torch.runtime import ServeEngine
    from repro_torch.server import FrontDoor

    eng = ServeEngine(model, params, num_pages=128, page_size=4,
                      max_pages_per_seq=16, device=device)
    fd = FrontDoor(BranchSession(eng, max_batch=8, seed=11), [])
    await fd.start_backend()
    try:
        resp = await fd.dispatch("POST", "/v1/generate", {
            "prompt": [5, 17, 3, 42, 7, 11, 2, 9, 30, 4, 8, 1, 22],
            "max_new_tokens": 12})
        events = [item async for item in resp.events]
        names = [e for e, _ in events]
        if (names[0] != "admitted" or names[-1] != "finished"
                or set(names[1:-1]) != {"token"}
                or len(events[-1][1]["generated"]) != 12):
            fail(f"front door on {device}: events {events}")
        commits = eng.obs.metrics.counter("kv.commits").value
        resp = await fd.dispatch("POST", "/v1/explore", {
            "prompt": [7, 8, 9], "policy": "best_of_n",
            "max_new_tokens": 12, "params": {"n": 3, "tokens": 6},
            "stream": False})
        pool = await fd.mux.call(lambda s: s.tree()["pool"])
        explore = {
            "status": resp.status, "event": resp.body.get("event"),
            "committed": resp.body.get("result", {}).get("committed"),
            "commits": eng.obs.metrics.counter("kv.commits").value - commits,
            "drained": pool["pages_free"] == pool["pages_total"]
            and pool["pages_reserved"] == 0}
    finally:
        await fd.shutdown(drain=True, timeout=60)
    return {"generate": events, "explore": explore}


#: the exploration phase's plan, one entry per prompt of phase 3's load:
#: (policy, its arguments, the request's max_new_tokens)
EXPLORE_PLAN = (
    [("best_of_n", dict(n=4, tokens=32), 33)] * 4
    + [("beam_search", dict(width=3, depth=2, tokens_per_level=8), 17)] * 2
    + [("tree_search", dict(fan_out=3, max_nodes=9, tokens_per_node=8), 25)]
    + [("speculative_decode", dict(n_drafts=3, draft_tokens=8), 10)])


def explore_run(model, params, prompts, plan, *, num_pages: int,
                prefix_cache: bool, device: str = "cuda",
                profile: bool = False) -> dict:
    """Every prompt through ``ExplorationDriver.explore`` on one
    ``BranchSession`` (page 16, 128 pages per sequence, max_batch 32),
    then ``driver.run()``.  Times each session step that decoded and the
    engine's decode inside it, each ``session.branch``/``commit`` and the
    ``engine.fork``/``commit`` inside them; with ``profile``, two driver
    rounds after the first forks run under the profiler instead (left out
    of the timings and the run's wall time)."""
    from repro_torch import explore_ctx
    from repro_torch.api import BranchSession
    from repro_torch.runtime import ServeEngine

    eng = ServeEngine(model, params, page_size=16, num_pages=num_pages,
                      max_pages_per_seq=128, prefix_cache=prefix_cache,
                      device=device)
    session = BranchSession(eng, max_batch=32, seed=1)
    driver = explore_ctx.ExplorationDriver(session)
    t = {k: [] for k in ("step_ms", "decode_ms", "host_ms", "batch",
                         "branch_us", "branch_n", "fork_us", "commit_us",
                         "engine_commit_us")}
    in_decode = [0.0]

    def timed(fn, after):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            after(time.perf_counter() - t0, out)
            return out
        return call

    def on_decode(dt, out):
        in_decode[0] += dt

    def on_step(dt, st):
        if st["decoded"]:
            t["step_ms"].append(dt * 1e3)
            t["decode_ms"].append(in_decode[0] * 1e3)
            t["host_ms"].append((dt - in_decode[0]) * 1e3)
            t["batch"].append(st["batch"])
        in_decode[0] = 0.0

    def on_branch(dt, kids):
        t["branch_us"].append(dt * 1e6)
        t["branch_n"].append(len(kids))

    def record(key):
        return lambda dt, out: t[key].append(dt * 1e6)

    step, decode = session.step, eng.decode
    eng.decode = timed(eng.decode, on_decode)
    eng.fork = timed(eng.fork, record("fork_us"))
    eng.commit = timed(eng.commit, record("engine_commit_us"))
    session.step = timed(session.step, on_step)
    session.branch = timed(session.branch, on_branch)
    session.commit = timed(session.commit, record("commit_us"))
    exps = [driver.explore(p, budget, getattr(explore_ctx, name),
                           name=f"{name}-{i}", **kw)
            for i, (p, (name, kw, budget)) in enumerate(zip(prompts, plan))]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    prof, prof_s = None, 0.0
    if profile:
        for _ in range(3):             # admissions, prefills, first forks
            driver.step()
        session.step, eng.decode = step, decode
        p0 = time.perf_counter()
        prof = profile_steps(driver.step)
        prof_s = time.perf_counter() - p0
        session.step = timed(step, on_step)
        eng.decode = timed(decode, on_decode)
    driver.run(raise_errors=False)
    sync()
    wall = time.perf_counter() - t0 - prof_s
    for e in exps:
        if e.error is not None:
            fail(f"exploration {e.name} failed: {e.error!r}")
    snap = eng.obs.metrics.snapshot()
    return {"results": [(e.name, e.result) for e in exps], "timing": t,
            "wall_s": wall, "driver_steps": driver.steps,
            "view": session.tree(), "stats": eng.stats(), "metrics": snap,
            "profile": prof}


def decode_control(model, params, prompts, steps: int = 8) -> dict:
    """The phase's load decoded straight through ``ServeEngine.decode``,
    in the same process state: phase 3's 32 lazy-CoW branches, ``steps``
    greedy steps, then ``steps`` sampled ones from a CUDA generator.
    Returns the step p50 ms of each."""
    from repro_torch.runtime import ServeEngine

    eng = ServeEngine(model, params, page_size=16, num_pages=2048,
                      max_pages_per_seq=128, prefix_cache=True)
    batch = [b for p in prompts for b in eng.fork(eng.add_request(p), 4)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name, kw in (("greedy", {}), ("sampled", dict(
            greedy=False, temperature=1.5, generator=gen))):
        ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            eng.decode(batch, **kw)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(ms)
    return out


def pcts(xs) -> str:
    return (f"p50 {np.percentile(xs, 50):.1f} p99 {np.percentile(xs, 99):.1f}"
            if len(xs) else "none")


def phase_explore(seed: int = 0) -> dict:
    """Phase 6: the public branch API at full width on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    log("== phase 6: the public branch API, qwen2-1.5b bf16, random "
        "weights: BranchSession + ExplorationDriver")
    cfg = get_config("qwen2-1.5b")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    rng = np.random.default_rng(seed)
    lens = [1024, 768, 128, 256, 384, 512, 640, 896]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    prompts[1][:512] = prompts[0][:512]        # a shared 512-token head
    zero_launches()
    with counted_calls() as calls:
        run = explore_run(model, params, prompts, EXPLORE_PLAN,
                          num_pages=2048, prefix_cache=True, profile=True)
    launches = launch_counts()
    log(f"attention calls {calls}, launches {launches}")
    launches_match_calls(launches, calls)
    if not (launches["paged_chunk_attention"] and launches["flash_attention"]):
        fail(f"a kernel of the path never launched: {launches}")
    want_commits = 0
    for name, res in run["results"]:
        st = res.stats
        brief = {k: v for k, v in st.items() if k not in ("scores", "levels")}
        log(f"{name}: committed={res.committed} generated "
            f"{len(res.generated)} {json.dumps(brief)}")
        if not res.committed or st.get("degraded"):
            fail(f"{name} did not commit a winner: {st}")
        if st["policy"] == "beam_search":
            if any(lv.get("degraded") for lv in st["levels"]):
                fail(f"{name} degraded a level with pages to spare")
            want_commits += len(st["levels"])
        elif st["policy"] == "tree_search":
            if st["branches_created"] != 9:
                fail(f"{name} created {st['branches_created']} of 9 nodes")
            want_commits += st["winner_depth"]
        else:
            want_commits += 1
    commits = run["metrics"]["counters"]["kv.commits"]
    log(f"commits {commits} (one per exclusive group: {want_commits})")
    if commits != want_commits:
        fail("an exploration committed other than one winner per group")
    st, view = run["stats"], run["view"]
    log(f"after finish: {view['pool']}, handles {view['handles']}, "
        f"sequences_live {st['sequences_live']}, prefix_pages_cached "
        f"{st['prefix_pages_cached']}")
    if (view["handles"]["open"] or st["sequences_live"]
            or view["pool"]["pages_reserved"] or st["token_tails"]
            or view["pool"]["pages_free"] + st["prefix_pages_cached"]
            != view["pool"]["pages_total"]):
        fail("the pool did not drain (free + prefix-cached pages)")
    card = card_line()
    t, hist = run["timing"], run["metrics"]["histograms"]
    counters = run["metrics"]["counters"]
    step_p50 = statistics.median(t["step_ms"])
    decode_p50 = statistics.median(t["decode_ms"])
    host_p50 = statistics.median(t["host_ms"])
    decoded = counters["engine.tokens_decoded"]
    tps = decoded / run["wall_s"]
    log(f"explore run: {decoded} tokens in {run['wall_s']:.3f} s, "
        f"{tps:.1f} tokens/s (prefills included, the profiled rounds not), "
        f"{run['driver_steps']} driver rounds, {len(t['step_ms'])} timed "
        f"decoding steps ({card})")
    log(f"session.step ms p50 {step_p50:.3f}; engine.decode inside it p50 "
        f"{decode_p50:.3f} ms; engine.decode_step_us p50 "
        f"{hist['engine.decode_step_us']['p50'] / 1e3:.3f} ms (obs "
        f"histogram, log2 buckets); scheduler + session host ms per step "
        f"outside engine.decode {pcts(t['host_ms'])} ({card})")
    log("engine.decode ms by step (rows): " + ", ".join(
        f"{ms:.1f} ({b})" for ms, b in zip(t["decode_ms"], t["batch"])))
    per_child = [u / n for u, n in zip(t["branch_us"], t["branch_n"])]
    log(f"session.branch us per call {pcts(t['branch_us'])}, per child "
        f"{pcts(per_child)} ({len(t['branch_us'])} calls of "
        f"{sorted(set(t['branch_n']))} children); engine.fork inside it "
        f"{pcts(t['fork_us'])} per call; obs engine.fork_us per child p50 "
        f"{hist['engine.fork_us']['p50']:.1f} p99 "
        f"{hist['engine.fork_us']['p99']:.1f} ({card})")
    log(f"session.commit us {pcts(t['commit_us'])} "
        f"({len(t['commit_us'])} calls); engine.commit inside it "
        f"{pcts(t['engine_commit_us'])}; obs engine.commit_us p50 "
        f"{hist['engine.commit_us']['p50']:.1f} p99 "
        f"{hist['engine.commit_us']['p99']:.1f} ({card})")

    control = decode_control(model, params, prompts)
    log(f"control, the same load through ServeEngine.decode at b=32 in "
        f"this process state: greedy step p50 {control['greedy']:.3f} ms, "
        f"sampled {control['sampled']:.3f} ms ({card})")

    log("-- page pressure: a pool too small for every fork")
    short = [prompts[0], prompts[2], prompts[3]]
    zero_launches()
    with counted_calls() as calls:
        pressure = explore_run(model, params, short, EXPLORE_PLAN[:3],
                               num_pages=80, prefix_cache=False)
    launches_match_calls(launch_counts(), calls)
    outcome = [(name, res.committed, bool(res.stats.get("degraded")))
               for name, res in pressure["results"]]
    view = pressure["view"]
    log(f"pressure outcomes {outcome}; pool {view['pool']}; handles "
        f"{view['handles']}")
    if not any(d for _, _, d in outcome) or not all(
            c != d for _, c, d in outcome):
        fail("page pressure degraded no exploration (or one neither "
             "committed nor degraded)")
    if (view["handles"]["open"] or view["pool"]["pages_free"]
            != view["pool"]["pages_total"]):
        fail("the pool did not drain after the page-pressure run")
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "tokens_per_s": tps,
            "step_ms_p50": step_p50, "decode_ms_p50": decode_p50,
            "host_ms_p50": host_p50, "profile": run["profile"],
            "control_ms_p50": control}


def phase_cli() -> None:
    """``python -m repro_torch.launch.serve`` on the card, as a user runs
    it."""
    log("-- python -m repro_torch.launch.serve --arch qwen2-1.5b "
        "--requests 2 --branches 4 --tokens 16")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-1.5b", "--requests", "2", "--branches", "4", "--tokens",
         "16"], cwd=ROOT, env=src_env(), capture_output=True, text=True,
        timeout=400)
    for ln in proc.stdout.splitlines():
        log(f"  | {ln}")
    log(f"exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    if (proc.returncode != 0
            or "session tree (procfs view):" not in proc.stdout
            or "handles: 0 open" not in proc.stdout):
        log(proc.stderr[-4000:])
        fail("the serving CLI did not serve on the card")


#: the front door's load, one entry per prompt of phase 3's: (endpoint,
#: tenant, body beyond the prompt)
FRONT_DOOR_PLAN = (
    [("generate", "interactive", dict(max_new_tokens=32))] * 4
    + [("explore", "interactive", dict(
        policy="best_of_n", max_new_tokens=33,
        params={"n": 4, "tokens": 32}))] * 2
    + [("explore", "interactive", dict(
        policy="beam", max_new_tokens=17,
        params={"width": 3, "depth": 2, "tokens_per_level": 8}))]
    + [("hold", "batch", dict(max_new_tokens=32))])


def front_door(model, params, *, num_pages: int, prefix_cache: bool,
               tenants: list, device: str = "cuda"):
    """A ``FrontDoor`` over a full-width ``BranchSession`` on the card
    (page 16, 128 pages per sequence, max_batch 32), with the engine
    thread's loop timed: each iteration that stepped gives the loop's ms
    (pressure relief, ``driver.step``, publishing) beside the
    ``session.step`` ms inside it."""
    from repro_torch.api import BranchSession
    from repro_torch.runtime import ServeEngine
    from repro_torch.server import FrontDoor

    eng = ServeEngine(model, params, page_size=16, num_pages=num_pages,
                      max_pages_per_seq=128, prefix_cache=prefix_cache,
                      device=device)
    session = BranchSession(eng, max_batch=32, seed=1)
    fd = FrontDoor(session, tenants)
    # per stepped iteration: {"loop": relief + driver.step + publish,
    # "driver": driver.step, "session": session.step inside driver.step}
    steps, relief, in_session = [], [0.0], [0.0]

    def timed(fn, after):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            after(time.perf_counter() - t0)
            return out
        return call

    def on_relieve(dt):
        relief[0] = dt

    def on_session(dt):
        in_session[0] += dt

    def on_driver(dt):
        steps.append({"loop": relief[0] + dt, "driver": dt,
                      "session": in_session[0], "published": False})
        in_session[0] = 0.0

    def on_publish(dt):
        if steps and not steps[-1]["published"]:
            steps[-1]["loop"] += dt
            steps[-1]["published"] = True

    fd.mux._relieve_pressure = timed(fd.mux._relieve_pressure, on_relieve)
    fd.driver.step = timed(fd.driver.step, on_driver)
    fd.mux._publish = timed(fd.mux._publish, on_publish)
    session.step = timed(session.step, on_session)
    return fd, eng, steps


async def consume(events, t0: float) -> dict:
    """Every SSE event of one stream: names, the client-clock time to the
    first ``token`` event, and the terminal event."""
    out = {"names": [], "ttft_s": None, "final": None, "tokens": 0}
    async for event, data in events:
        out["names"].append(event)
        if event == "token":
            out["tokens"] += len(data["tokens"])
            if out["ttft_s"] is None:
                out["ttft_s"] = time.perf_counter() - t0
        if event in ("finished", "result", "evicted", "error"):
            out["final"] = (event, data)
    out["wall_s"] = time.perf_counter() - t0
    return out


def ledger(session) -> tuple:
    c = session.obs.metrics.snapshot()["counters"]
    return (c.get("sched.submitted", 0), c.get("sched.rejected", 0),
            session.sched.stats()["pages_reserved"])


async def front_door_run(fd, prompts, steps: list) -> dict:
    """Phase 7's main run over real sockets: the plan's eight clients at
    once, a ``batch`` request beyond its page quota (429, ledger
    untouched), the introspection endpoints, then a drain with one stream
    in flight."""
    from repro_torch.server import ServeClient, ServeError

    server = await fd.serve("127.0.0.1", 0)
    client = ServeClient(f"http://127.0.0.1:"
                         f"{server.sockets[0].getsockname()[1]}")
    t0 = time.perf_counter()
    jobs = []
    for prompt, (kind, tenant, body) in zip(prompts, FRONT_DOOR_PLAN):
        if kind == "generate":
            jobs.append(consume(client.generate_events(
                prompt, tenant=tenant, **body), t0))
        elif kind == "explore":
            jobs.append(consume(client.explore_events(
                prompt, tenant=tenant, **body), t0))
        else:
            jobs.append(client.hold(prompt, tenant=tenant, **body))
    results = await asyncio.gather(*jobs)
    wall = time.perf_counter() - t0
    # the concurrent run's counters and engine steps (the hold is parked:
    # nothing steps until the drain's stream below)
    counters = await fd.mux.call(
        lambda s: s.obs.metrics.snapshot()["counters"])
    n_steps = await fd.mux.call(lambda s: len(steps))
    streams, held = results[:-1], results[-1]
    for (kind, _, body), res in zip(FRONT_DOOR_PLAN, streams):
        event, data = res["final"]
        if kind == "generate" and (
                res["names"][0] != "admitted" or event != "finished"
                or len(data["generated"]) != body["max_new_tokens"]
                or res["tokens"] != body["max_new_tokens"]):
            fail(f"a streamed /v1/generate did not finish: {res}")
        if kind == "explore" and (event != "result"
                                  or not data["result"]["committed"]):
            fail(f"a /v1/explore did not commit: {res}")
    if not held.get("held"):
        fail(f"the batch hold was not parked: {held}")

    before = await fd.mux.call(ledger)
    try:
        await client.hold(prompts[2], tenant="batch", max_new_tokens=32)
        fail("a batch request beyond its page quota was admitted")
    except ServeError as err:
        quota = (err.status, err.body.get("errno"))
    after = await fd.mux.call(ledger)
    if quota != (429, "EAGAIN") or after != before:
        fail(f"quota: {quota}, ledger {before} -> {after}")

    metrics = await client.metrics()
    tenants = await client.tenants()
    tree = await client.tree(held["id"])
    health = await client.health()
    if ("server.requests" not in metrics or not health["ok"]
            or tree["kind"] != "parked" or not tree["stat"]["held"]
            or tenants["tenants"]["batch"]["live"] != 1):
        fail(f"introspection: health {health}, tree {tree}, tenants "
             f"{tenants}")

    # a drain with one stream in flight: it finishes, the hold is evicted
    events = client.generate_events(prompts[3], tenant="interactive",
                                    max_new_tokens=32)
    first = await events.__anext__()
    rest = asyncio.ensure_future(consume(events, time.perf_counter()))
    stats = await fd.shutdown(drain=True, timeout=120)
    inflight = await rest
    refused = await fd.dispatch("POST", "/v1/generate", {
        "prompt": prompts[3], "max_new_tokens": 4})
    rec = fd.registry.get(held["id"])
    if (first[0] != "admitted" or inflight["final"][0] != "finished"
            or len(inflight["final"][1]["generated"]) != 32):
        fail(f"the in-flight stream was cut by the drain: {inflight}")
    if refused.status != 503 or rec.state != "evicted" or stats["evicted"] < 1:
        fail(f"drain: {stats}, new request {refused.status}, hold "
             f"{rec.state}")
    return {"streams": streams, "wall_s": wall, "quota": quota,
            "drain": stats, "tenants": tenants["tenants"],
            "health": health, "counters": counters,
            "steps": steps[:n_steps]}


async def until_admitted(fd, sid: int) -> dict:
    for _ in range(2000):
        view = (await fd.dispatch("GET", f"/v1/sessions/{sid}/tree")).body
        if view["state"] == "running":
            return view
        await asyncio.sleep(0.01)
    fail(f"request {sid} was never admitted: {view}")


async def pressure_run(fd, prompts) -> dict:
    """Phase 7's small pool (80 pages of 16, prefix cache off): a batch
    chat, a batch hold of 1024 tokens, an equal-priority batch chat that
    cannot fit beside it, a second batch hold, then an interactive chat
    that cannot fit beside that.  Each seat is won by demoting the held
    request to the tier store (lossless); nothing is evicted mid-flight;
    the drain evicts both holds, and each eviction event carries the
    hold's committed chain."""
    from repro_torch.server import ServeClient

    server = await fd.serve("127.0.0.1", 0)
    client = ServeClient(f"http://127.0.0.1:"
                         f"{server.sockets[0].getsockname()[1]}")
    done = await client.generate(prompts[2], tenant="batch",
                                 max_new_tokens=8)
    h1 = await client.hold(prompts[0], tenant="batch", max_new_tokens=32)
    await until_admitted(fd, h1["id"])
    same = await client.generate(prompts[3], tenant="batch",
                                 max_new_tokens=32)
    h2 = await client.hold(prompts[6], tenant="batch", max_new_tokens=32)
    await until_admitted(fd, h2["id"])
    vip = await client.generate(prompts[1], tenant="interactive",
                                max_new_tokens=32)
    views = [await client.tree(h["id"]) for h in (h1, h2)]
    counters = fd.session.obs.metrics.snapshot()["counters"]
    for name, res, n in (("batch chat", done, 8), ("equal-priority chat",
                                                   same, 32),
                         ("interactive chat", vip, 32)):
        if res["event"] != "finished" or len(res["generated"]) != n:
            fail(f"{name} was not served: {res}")
    if not all(v["demoted"] and v["stat"]["tiered"] and v["state"]
               == "running" for v in views):
        fail(f"the holds were not demoted losslessly: {views}")
    if counters.get("server.preemptions", 0) or \
            counters["server.demotions"] != 2:
        fail(f"preemption counters: {counters}")
    stats = await fd.shutdown(drain=True, timeout=120)
    evictions = []
    for h, prompt in ((h1, prompts[0]), (h2, prompts[6])):
        rec = fd.registry.get(h["id"])
        items = []
        while not rec.queue.empty():
            items.append(rec.queue.get_nowait())
        names = [i[0] for i in items if i is not None]
        last = items[-2] if len(items) > 1 else None
        if (names[:2] != ["admitted", "demoted"] or last[0] != "evicted"
                or "EV_INVALIDATED" not in last[1]["events"]
                or last[1]["tokens"] != prompt or items[-1] is not None):
            fail(f"hold {h['id']}: events {names}, last {last}")
        evictions.append((names, len(last[1]["tokens"]),
                          last[1]["reason"]))
    view = fd.session.tree()
    if view["handles"]["open"] or view["pool"]["pages_free"] != \
            view["pool"]["pages_total"]:
        fail(f"the small pool did not drain: {view}")
    return {"evictions": evictions, "drain": stats,
            "demotions": counters["server.demotions"],
            "sched_demotions": counters["sched.demotions"],
            "preemptions": counters.get("server.preemptions", 0),
            "reasons": [v.get("evict_reason") for v in views]}


def phase_front_door(seed: int = 0) -> dict:
    """Phase 7: the HTTP/SSE front door at full width on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.server import TenantConfig

    log("== phase 7: the front door, qwen2-1.5b bf16, random weights: "
        "FrontDoor.serve + ServeClient over sockets")
    cfg = get_config("qwen2-1.5b")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    rng = np.random.default_rng(seed)
    lens = [1024, 768, 128, 256, 384, 512, 640, 896]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    prompts[1][:512] = prompts[0][:512]        # a shared 512-token head
    # batch may reserve what its one hold needs: a second request is 429
    hold_pages = -(-(lens[7] + 32) // 16)
    tenants = [TenantConfig("interactive", max_concurrent=16, priority=2),
               TenantConfig("batch", max_concurrent=8, priority=1,
                            max_reserved_pages=hold_pages)]
    fd, eng, steps = front_door(model, params, num_pages=2048,
                                prefix_cache=True, tenants=tenants)
    zero_launches()
    with counted_calls() as calls:
        run = asyncio.run(front_door_run(fd, prompts, steps))
    launches = launch_counts()
    log(f"attention calls {calls}, launches {launches}")
    launches_match_calls(launches, calls)
    if not (launches["paged_chunk_attention"] and launches["flash_attention"]):
        fail(f"a kernel of the path never launched: {launches}")
    st, view = eng.stats(), fd.session.tree()
    log(f"after the drain: {view['pool']}, handles {view['handles']}, "
        f"sequences_live {st['sequences_live']}, prefix_pages_cached "
        f"{st['prefix_pages_cached']}; drain {run['drain']}; quota "
        f"{run['quota']}")
    if (view["handles"]["open"] or st["sequences_live"]
            or view["pool"]["pages_reserved"] or st["token_tails"]
            or view["pool"]["pages_free"] + st["prefix_pages_cached"]
            != view["pool"]["pages_total"]):
        fail("the pool did not drain (free + prefix-cached pages)")
    card = card_line()
    counters = run["counters"]
    ttft = [r["ttft_s"] * 1e3 for r in run["streams"]]
    chat_ttft = ttft[:4]
    decoded = counters["engine.tokens_decoded"]
    streamed = counters["server.tokens_streamed"]
    stepped = [s for s in run["steps"] if s["session"]]
    loop_ms = [s["loop"] * 1e3 for s in stepped]
    driver_ms = [s["driver"] * 1e3 for s in stepped]
    sess_ms = [s["session"] * 1e3 for s in stepped]
    own_ms = [(s["loop"] - s["driver"]) * 1e3 for s in stepped]
    log(f"front door run: {len(run['streams'])} streams and a hold in "
        f"{run['wall_s']:.3f} s; {decoded} tokens decoded "
        f"({decoded / run['wall_s']:.1f} tokens/s), {streamed} streamed "
        f"({streamed / run['wall_s']:.1f} tokens/s) ({card})")
    log(f"time to first token ms (client clock, to the first token event): "
        f"streamed /v1/generate {pcts(chat_ttft)}; every stream "
        f"{pcts(ttft)} ({card})")
    log(f"engine loop ms per step {pcts(loop_ms)}; driver.step inside it "
        f"{pcts(driver_ms)} (admission prefills, policy resumption and "
        f"forks, session.step); session.step {pcts(sess_ms)}; the "
        f"multiplexer's own ms per step (loop - driver.step: pressure "
        f"relief, publishing) {pcts(own_ms)} over {len(loop_ms)} steps "
        f"({card})")

    log("-- a small pool: demotion seats the waiting chats, the drain "
        "evicts the holds")
    fd2, eng2, _ = front_door(model, params, num_pages=80,
                              prefix_cache=False, tenants=[
                                  TenantConfig("interactive", 16,
                                               priority=2),
                                  TenantConfig("batch", 8, priority=1)])
    zero_launches()
    with counted_calls() as calls2:
        pressure = asyncio.run(pressure_run(fd2, prompts))
    launches2 = launch_counts()
    launches_match_calls(launches2, calls2)
    log(f"small pool: demotions {pressure['demotions']} (scheduler "
        f"{pressure['sched_demotions']}), lossy preemptions "
        f"{pressure['preemptions']}; holds' events and eviction at drain "
        f"{pressure['evictions']}; drain {pressure['drain']}")
    serve_cli_run()
    del params
    torch.cuda.empty_cache()
    return {"launches": {k: launches[k] + launches2[k] for k in launches},
            "ttft_ms": {"generate": pcts(chat_ttft), "all": pcts(ttft)},
            "tokens_per_s": decoded / run["wall_s"],
            "streamed_per_s": streamed / run["wall_s"],
            "loop_ms_p50": statistics.median(loop_ms),
            "driver_step_ms_p50": statistics.median(driver_ms),
            "session_step_ms_p50": statistics.median(sess_ms),
            "mux_ms_p50": statistics.median(own_ms),
            "mux_ms_p99": float(np.percentile(own_ms, 99))}


def serve_cli_run() -> None:
    """``python -m repro_torch.launch.serve --serve 127.0.0.1:0`` on the
    card: read the address it prints, send two requests with
    ``ServeClient``, SIGINT, and expect a clean drain."""
    import signal
    import threading

    from repro_torch.server import ServeClient

    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "qwen2-1.5b", "--serve", "127.0.0.1:0", "--tenants",
            "interactive:16:2"]
    log("-- " + " ".join(["python"] + argv[1:]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=ROOT, env=src_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    watchdog = threading.Timer(400, proc.kill)
    watchdog.start()
    try:
        first = proc.stdout.readline().strip()
        log(f"  | {first}")
        if not first.startswith("serving on http://"):
            fail("the --serve CLI did not start: "
                 f"{proc.stderr.read()[-4000:]}")
        client = ServeClient(first.split()[2])

        async def two():
            return await asyncio.gather(
                client.generate([11, 22, 33, 44], tenant="interactive",
                                max_new_tokens=16),
                client.explore([5, 6, 7], policy="best_of_n",
                               tenant="interactive", max_new_tokens=9,
                               params={"n": 4, "tokens": 8}))
        fin, res = asyncio.run(two())
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for ln in out.splitlines():
        log(f"  | {ln}")
    log(f"exit {proc.returncode} in {time.perf_counter() - t0:.1f} s: "
        f"generate {fin['event']} ({len(fin['generated'])} tokens), explore "
        f"{res['event']} (committed {res['result']['committed']})")
    if (proc.returncode != 0 or "drained cleanly" not in out
            or fin["event"] != "finished" or len(fin["generated"]) != 16
            or res["event"] != "result" or not res["result"]["committed"]):
        log(err[-4000:])
        fail("the --serve CLI did not serve and drain on the card")


def src_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get(
            "PYTHONPATH") else []))
    return env


def phase_device_explore() -> dict:
    """Phase 8: ``repro_torch.core.explore`` on the card, the scenarios of
    the reference's device-explore tests, every round under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises)."""
    import importlib

    E = importlib.import_module("repro_torch.core.explore")
    log("== phase 8: device-side exploration (torch.func.vmap) with no host "
        "sync")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def noise_step(state, key):
        noise = E.normal(key, (2,))
        loss = torch.sum(noise ** 2)
        return {"x": noise, "loss": loss}, loss < state["loss"], loss

    def stuck_step(state, key):
        return ({"x": state["x"] + 1}, torch.zeros((), dtype=torch.bool,
                                                   device=dev),
                torch.zeros((), device=dev))

    def loss_fn(x):
        return torch.sum((x - 3.0) ** 2)

    def gd_step(state, key):
        g = torch.func.grad(loss_fn)(state["x"])
        new_x = state["x"] - (0.1 + 0.2 * E.uniform(key)) * g
        return {"x": new_x}, loss_fn(new_x) < loss_fn(state["x"]), \
            loss_fn(new_x)

    origin = {"x": torch.zeros(2, device=dev),
              "loss": torch.full((), 100.0, device=dev)}
    five = {"x": torch.full((2,), 5.0, device=dev)}
    state = {"x": torch.zeros(4, device=dev)}
    winners = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = E.explore(noise_step, origin, 4, gen,
                        commit_time_fn=lambda aux: aux)
        kept = E.explore(stuck_step, five, 3, gen)
        for _ in range(25):
            r = E.explore(gd_step, state, 4, gen,
                          commit_time_fn=lambda aux: aux)
            winners.append((r.winner, torch.argmin(r.aux)))
            state = r.state
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    losses = res.aux.cpu()
    final = float(loss_fn(state["x"]))
    bits = E.uniform(torch.tensor([1, 2], device=dev), (2,)).cpu().tolist()
    out = {"winner": int(res.winner), "argmin": int(torch.argmin(losses)),
           "committed": bool(res.committed),
           "kept_origin": bool(torch.equal(kept.state["x"], five["x"]))
           and not bool(kept.committed),
           "gd_winners_are_argmin": all(int(w) == int(a)
                                        for w, a in winners),
           "gd_final_loss": final, "bits": bits, "ms": ms}
    log(f"device explore: {json.dumps(out)}")
    if (out["winner"] != out["argmin"] or not out["committed"]
            or abs(float(res.state["loss"]) - float(losses.min())) > 1e-6
            or not out["kept_origin"] or not out["gd_winners_are_argmin"]
            or final >= 1e-3
            or bits != [0.10696852207183838, 0.7602502703666687]):
        fail("device-side exploration disagrees with its invariants")
    return out


def phase_branchfs() -> dict:
    """Phase 9: BranchFS on the card's host: ``create`` µs over bases of
    10, 1 000 and 10 000 files, and ``commit`` µs for 1, 10 and 100
    modified files (each commit must leave its sibling stale)."""
    import tempfile

    from repro_torch.fs import BranchFS

    log(f"== phase 9: BranchFS on this machine's disk ({os.uname().nodename}"
        f", {os.cpu_count()} cores)")
    work = ROOT / "build" / "branchfs_timing"
    work.mkdir(parents=True, exist_ok=True)
    out = {"create_us": {}, "commit_us": {}}
    for n in (10, 1_000, 10_000):
        with tempfile.TemporaryDirectory(dir=work) as td:
            fs = BranchFS(td)
            t0 = time.perf_counter()
            for i in range(n):
                fs.write("base", f"f{i}", b"x" * 64)
            build_s = time.perf_counter() - t0
            create = []
            for _ in range(200):
                t0 = time.perf_counter()
                (b,) = fs.create()
                create.append((time.perf_counter() - t0) * 1e6)
                fs.abort(b)
            out["create_us"][n] = pcts(create)
            commits = {}
            for k in (1, 10, 100):
                us = []
                for _ in range(20):
                    mine, sib = fs.create(n=2)
                    for i in range(k):
                        fs.write(mine, f"f{i}", b"y" * 64)
                    t0 = time.perf_counter()
                    fs.commit(mine)
                    us.append((time.perf_counter() - t0) * 1e6)
                    if fs.status(sib) != "stale":
                        fail(f"commit left sibling {sib} {fs.status(sib)}")
                commits[k] = pcts(us)
            out["commit_us"][n] = commits
            fs.close()
        log(f"base {n} files (built in {build_s:.1f} s): create us "
            f"{out['create_us'][n]}; commit us by modified files "
            f"{commits}")
    return out


#: phase 11's paged configs, served through ServeEngine at full width and
#: depth (pixtral-12b text only, as the JAX engine serves it), and their
#: prompts (b = 16 after the forks)
FAMILY_CONFIGS = ("granite-8b", "nemotron-4-15b", "stablelm-12b",
                  "pixtral-12b")
FAMILY_PROMPTS = (1024, 768, 384, 128)


def contiguous_run(model, params, *, b: int, s: int, steps: int,
                   patches: int = 0, max_len: int = 0,
                   device: str = "cuda", seed: int = 0) -> dict:
    """The JAX package's contiguous-cache serving path: ``Model.prefill``
    of ``b`` prompts of ``s`` tokens (``[b, s, cb]`` for several codebooks;
    with ``patches``, a seeded ``frontend_embed`` over the first
    positions; K2 over every position), then ``steps`` greedy
    ``decode_step``s at per-row positions.  Inputs come from numpy, so
    both devices see the same ones.  Logits must be finite and of the
    config's shape; K2 is called once per layer, and on the card launched
    once per call.  Returns the greedy tokens (per codebook) and the
    times; tokens/s counts each codebook's token (``b * cb`` a step)."""
    cfg = model.cfg
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rng = np.random.default_rng(seed)
    cb = cfg.num_codebooks
    shape = (b, s, cb) if cb > 1 else (b, s)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))
    fe = None
    if patches:
        fe = torch.from_numpy(rng.standard_normal(
            (b, patches, cfg.d_model), np.float32)).to(device)
    want = (b, 1, cb, cfg.vocab_size) if cb > 1 else (b, 1, cfg.vocab_size)
    zero_launches()
    with counted_calls() as calls:
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, tokens.to(device), fe,
                                      max_len=max_len or s + steps)
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        out, step_ms = [], []
        for i in range(steps):
            if tuple(logits.shape) != want or not torch.isfinite(
                    logits).all():
                fail(f"{cfg.name}: logits {tuple(logits.shape)} (want "
                     f"{want}) or not finite at step {i}")
            tok = logits[:, -1].argmax(-1)          # [b] or [b, cb]
            out.append(tok.tolist())
            pos = torch.full((b,), s + i, device=device)
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, tok[:, None],
                                              pos)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    if calls["flash_attention"] != cfg.num_layers:
        fail(f"{cfg.name}: {calls['flash_attention']} K2 calls for one "
             f"{cfg.num_layers}-layer prefill")
    if cuda:
        launches_match_calls(launches, calls)
    p50 = statistics.median(step_ms)
    return {"tokens": out, "prefill_ms": round(prefill_ms, 3),
            "decode_step_ms_p50": round(p50, 3),
            "decode_tokens_per_s": round(b * cb / p50 * 1e3, 1),
            "positions": s, "launches": launches}


def phase_families(seed: int = 0) -> dict:
    """Phase 11: the dense, VLM and audio configs at full width and depth
    in bf16, one at a time, each freed before the next."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    log("== phase 11: granite-8b, nemotron-4-15b, stablelm-12b, "
        "pixtral-12b and musicgen-medium at full width and depth, bf16, "
        "random weights")
    out = {}
    card = card_line()
    for name in FAMILY_CONFIGS + ("musicgen-medium",):
        cfg = get_config(name)
        model = Model(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated()
        res = {"params_b": round(cfg.param_count() / 1e9, 3),
               "init_s": round(time.perf_counter() - t0, 1),
               "init_peak_gb": round(init_peak / 1e9, 2)}
        if name in FAMILY_CONFIGS:
            res["fused"] = serve_dense(model, params, attn_impl="auto",
                                       steps=16, lens=FAMILY_PROMPTS,
                                       seed=seed)
            res["ref"] = serve_dense(model, params, attn_impl="ref",
                                     steps=4, lens=FAMILY_PROMPTS, seed=seed)
        if name == "pixtral-12b":
            res["image"] = contiguous_run(model, params, b=2, s=1152,
                                          steps=16, patches=1024, seed=seed)
        if name == "musicgen-medium":
            res["audio"] = contiguous_run(model, params, b=8, s=512,
                                          steps=32, max_len=1024, seed=seed)
        for key in ("image", "audio"):
            if key in res:
                r = res[key]
                log(f"{name} {key} through Model.prefill/decode_step: "
                    f"prefill {r['prefill_ms']} ms over {r['positions']} "
                    f"positions, step p50 {r['decode_step_ms_p50']} ms, "
                    f"{r['decode_tokens_per_s']} tokens/s, launches "
                    f"{r['launches']} ({card})")
        res["max_allocated_gb"] = round(
            torch.cuda.max_memory_allocated() / 1e9, 2)
        log(f"{name}: {res['params_b']} B params, init {res['init_s']} s, "
            f"init peak {res['init_peak_gb']} GB, max allocated "
            f"{res['max_allocated_gb']} GB")
        out[name] = res
        del params
    torch.cuda.empty_cache()
    return out


#: phase 12: zamba2-7b's prompts (each its own BranchStore, forked 4 ways:
#: b = 16), its cache length (the longest prompt and 32 steps) and the
#: MoE configs' depths (full width; the full depths do not fit one card:
#: 94 layers of qwen3-moe-235b-a22b are 470 GB in bf16, 40 of dbrx-132b 263 GB)
HYBRID_PROMPTS = (512, 1024, 1536, 2048)
HYBRID_MAX_LEN = 2080
MOE_LAYERS = {"qwen3-moe-235b-a22b": 12, "dbrx-132b": 8}


def phase_hybrid_moe(seed: int = 0) -> dict:
    """Phase 12: zamba2-7b at full width and depth through Model and
    BranchStore, then the two MoE configs at full width and cut depth
    through ServeEngine, bf16, one config at a time, each freed before the
    next."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    log("== phase 12: zamba2-7b (full width and depth), qwen3-moe-235b-a22b "
        f"({MOE_LAYERS['qwen3-moe-235b-a22b']} layers) and dbrx-132b "
        f"({MOE_LAYERS['dbrx-132b']} layers) at full width, bf16, random "
        "weights")
    card = card_line()
    out = {}

    def init(cfg):
        model = Model(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        return model, params, {
            "params_b": round(sum(p.numel() for p in _leaves(params)) / 1e9,
                              3),
            "weights_gb": round(sum(p.nbytes for p in _leaves(params)) / 1e9,
                                2),
            "init_s": round(time.perf_counter() - t0, 1),
            "init_peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2)}

    # --- zamba2-7b: K4 and K2 (hd 112) in prefill, the branching cycle ----
    cfg = get_config("zamba2-7b")
    model, params, res = init(cfg)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in HYBRID_PROMPTS]
    zero_launches()
    with counted_calls() as calls:
        # 29 timed steps and 3 under the profiler: 32 positions past the
        # longest prompt
        run = ssm_cycle(model, params, prompts, n_branches=4, steps=29,
                        device="cuda", timed=True, max_len=HYBRID_MAX_LEN)
    launches = launch_counts()
    n_apps = cfg.num_layers // cfg.attn_every
    log(f"zamba2-7b launches on the path: {launches}; flash_attention "
        f"calls {calls['flash_attention']}")
    if (launches["ssd_scan"] != cfg.num_layers * len(prompts)
            or calls["flash_attention"] != n_apps * len(prompts)):
        fail(f"expected {cfg.num_layers} ssd_scan and {n_apps} "
             f"flash_attention launches per prefill: {launches}, {calls}")
    launches_match_calls(launches, {"flash_attention":
                                    calls["flash_attention"]})
    drift = abs(run["mem_after"] - run["mem_before"]) / run["mem_before"]
    log(f"zamba2-7b device memory before the fork "
        f"{run['mem_before'] / 1e9:.3f} GB, after commit and reap "
        f"{run['mem_after'] / 1e9:.3f} GB ({drift:.2%} apart)")
    if drift > 0.05:
        fail("the reaped hybrid branches' states were not released")
    for toks in run["tokens"]:
        if len(toks) != 33 or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"bad hybrid branch tokens {toks}")
    for state in run["states"]:
        if not all(torch.isfinite(v).all() for v in state.values()):
            fail("the committed hybrid state is not finite")
    p50 = statistics.median(run["step_ms"])
    prof = run["profile"]
    busy = (None if prof.get("idle_share") is None
            else round(1 - prof["idle_share"], 3))
    res["hybrid"] = {
        "prefill_ms": [round(x, 3) for x in run["prefill_ms"]],
        "decode_step_ms_p50": round(p50, 3),
        "decode_tokens_per_s": round(16 / p50 * 1e3, 1),
        "device_busy_share": busy, "launches": launches,
        "prefill_lengths": list(HYBRID_PROMPTS)}
    res["max_allocated_gb"] = round(torch.cuda.max_memory_allocated() / 1e9,
                                    2)
    log(f"zamba2-7b prefill ms per request (prompt {list(HYBRID_PROMPTS)}): "
        f"{res['hybrid']['prefill_ms']} ({card})")
    log(f"zamba2-7b decode step ms p50 {p50:.3f} (b=16: 4 requests x 4 "
        f"branches, max_len {HYBRID_MAX_LEN}), "
        f"{res['hybrid']['decode_tokens_per_s']} tokens/s, device busy "
        f"share {busy} ({card})")
    log(f"zamba2-7b: {res['params_b']} B params ({res['weights_gb']} GB), "
        f"init {res['init_s']} s, init peak {res['init_peak_gb']} GB, max "
        f"allocated {res['max_allocated_gb']} GB")
    out["zamba2-7b"] = res
    del params, run
    torch.cuda.empty_cache()

    # --- the MoE configs through ServeEngine (phase 11's load) ------------
    for name, layers in MOE_LAYERS.items():
        cfg = dataclasses.replace(get_config(name), num_layers=layers)
        model, params, res = init(cfg)
        res["layers"] = layers
        res["fused"] = serve_dense(model, params, attn_impl="auto",
                                   steps=16, lens=FAMILY_PROMPTS, seed=seed)
        res["ref"] = serve_dense(model, params, attn_impl="ref", steps=4,
                                 lens=FAMILY_PROMPTS, seed=seed)
        res["max_allocated_gb"] = round(
            torch.cuda.max_memory_allocated() / 1e9, 2)
        log(f"{name} ({layers} of {get_config(name).num_layers} layers): "
            f"{res['params_b']} B params ({res['weights_gb']} GB), init "
            f"{res['init_s']} s, init peak {res['init_peak_gb']} GB, max "
            f"allocated {res['max_allocated_gb']} GB")
        out[name] = res
        del params
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# training (phase 2's gradient checks, phase 5's parity, phase 13)
# ---------------------------------------------------------------------------

def kernel_grads(gen) -> None:
    """Phase 2's training checks: the K2 and K4 autograd Functions (the
    kernel forward, the plain recompute backward) against autograd through
    the plain versions, f32 and bf16 (TOL's relative term and
    ``GRAD_SCALE_TOL`` of each gradient's largest magnitude): K2's gradients for q, k, v
    at qwen2-1.5b's widths (s 1023 and 2048, chunk 1024) against the
    chunked attention, K4's for x, dt, A, B, C at mamba2-2.7b's (s 1000
    and 2048) against ``ssd_scan_ref``; then each Function's vmap rule over
    2 branches (one launch) against two plain calls, forward and
    gradients."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.layers import chunked_causal_attention

    def held(label, got, want, names):
        for name, a, b in zip(names, got, want):
            c = compare(a, b, grad=True)
            log(f"{label} d{name}: {tol_text(c, b.dtype, grad=True)}")
            if not c["ok"]:
                fail(f"{label}: the gradient for {name} disagrees with "
                     "autograd through the plain version")

    def grads(out, inputs, g):
        return torch.autograd.grad(out, inputs, g)

    bf16, f32 = torch.bfloat16, torch.float32
    for s in (1023, 2048):
        for dtype in (bf16, f32):
            q, k, v = (x.requires_grad_()
                       for x in flash_case(gen, s=s, dtype=dtype))
            g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            held(f"K2 grad h=12 kv=2 hd=128 s={s} {str(dtype)[6:]}",
                 grads(flash_attention(q, k, v, 1024), (q, k, v), g),
                 grads(chunked_causal_attention(q, k, v, chunk=1024),
                       (q, k, v), g), ("q", "k", "v"))
    for s in (1000, 2048):
        for dtype in (bf16, f32):
            args = [a.requires_grad_() for a in ssd_case(gen, s=s,
                                                          dtype=dtype)]
            y, _ = ssd_scan(*args)
            gy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
            held(f"K4 grad H=80 P=64 N=128 s={s} {str(dtype)[6:]}",
                 grads(y, args, gy), grads(ssd_scan_ref(*args)[0], args, gy),
                 ("x", "dt", "A", "B", "C"))

    # vmap over 2 branches: one launch each, against two plain calls
    q, k, v = (torch.stack([x, 0.5 * x]) for x in flash_case(gen, s=1023,
                                                               dtype=f32))
    g = torch.randn(q.shape, generator=gen, device="cuda")
    n0 = launch_counts()["flash_attention"]
    out = torch.func.vmap(flash_attention)(q, k, v)
    got = torch.func.vmap(torch.func.grad(
        lambda *a: (flash_attention(*a[:3]) * a[3]).sum(),
        argnums=(0, 1, 2)))(q, k, v, g)
    launches = launch_counts()["flash_attention"] - n0
    for i in range(2):
        c = compare(out[i], flash_attention_ref(q[i], k[i], v[i]))
        log(f"K2 vmap branch {i} of 2: {tol_text(c, f32)}")
        if not c["ok"]:
            fail("the K2 vmap rule disagrees with a plain call")
        qi, ki, vi = (x[i].clone().requires_grad_() for x in (q, k, v))
        held(f"K2 vmap(grad) branch {i} of 2", [t[i] for t in got],
             grads(chunked_causal_attention(qi, ki, vi), (qi, ki, vi), g[i]),
             ("q", "k", "v"))
    x, dt, A, B, C = ssd_case(gen, s=1000, dtype=f32)
    xs, As = torch.stack([x, 0.5 * x]), torch.stack([A, 0.5 * A])
    n0 = launch_counts()["ssd_scan"]
    shared = torch.func.vmap(ssd_scan, in_dims=(0, None, None, None, None))(
        xs, dt, A, B, C)
    ssd_launches = launch_counts()["ssd_scan"] - n0
    mapped = torch.func.vmap(ssd_scan, in_dims=(0, None, 0, None, None))(
        xs, dt, As, B, C)
    for i in range(2):
        for label, res, a in (("A shared", shared, A),
                              ("A mapped", mapped, As[i])):
            y_ref, st_ref = ssd_scan_ref(xs[i], dt, a, B, C)
            cy, cs = compare(res[0][i], y_ref), compare(res[1][i], st_ref)
            log(f"K4 vmap ({label}) branch {i} of 2: y {tol_text(cy, f32)}"
                f"; state {tol_text(cs, f32)}")
            if not (cy["ok"] and cs["ok"]):
                fail("the K4 vmap rule disagrees with a plain call")
    log(f"vmap rules: K2 {launches} launches for a forward and a "
        f"vmap(grad) of 2 branches, K4 {ssd_launches} for 2 branches "
        "sharing A")
    if launches != 2 or ssd_launches != 1:
        fail("a vmap rule did not fold its branches into one launch")


def _state_to(state, device):
    """A TrainState on ``device``."""
    return state._replace(
        params=_to(state.params, device),
        opt_state=_to(state.opt_state, device),
        ef=None if state.ef is None else type(state.ef)(
            _to(state.ef.residual, device)),
        step=state.step.to(device))


def _state_leaves(state) -> list:
    """Every stored tensor of a state (a blocked leaf's blocks each)."""
    import torch.utils._pytree as pytree

    return [x for x in pytree.tree_leaves(state) if x is not None]


def _whole_leaves(tree) -> list:
    """Every leaf of a tree whole (a blocked leaf's blocks gathered)."""
    from repro_torch.distributed import blocked

    return [blocked.whole(x) for x in blocked.leaves(tree)]


#: phase 5's training parity configs: (name, layers, batch, sequence)
TRAIN_PARITY = (("paper-agentic", None, 4, 128), ("mamba2-2.7b", 4, 4, 64))
TRAIN_PARITY_LR = 1e-3


def train_parity() -> None:
    """Phase 5's training checks, float32, card (kernels) against CPU
    (plain): ``paper-agentic`` and mamba2-2.7b's widths at 4 layers, each 3
    steps of ``build_train_step`` (AdamW, clip 1.0, accum_steps 2) from one
    state on the same batches: the losses and grad norms within 1e-4
    relative, the parameters within 1e-5 of each leaf's largest magnitude
    but for at most 0.1% of all elements, which are held within ``2 * lr``
    (AdamW's first step is ±lr per element, ``m̂/√v̂ = sign(g)``, so an
    element whose gradient lies within the two devices' rounding of zero
    may move the other way; a missing, sign-flipped or undecayed step moves
    far more elements; the mean difference is printed beside it).  Then on the
    card: a ``FaultTolerantTrainer`` run whose injected NaN rolls back to a
    bit-identical committed state; a checkpoint at step 4 restored into a
    new trainer that replays the exact stream (the same batches, losses
    within 1e-5: the embedding's backward adds with atomics); a
    ``speculative_step`` with one replica delayed and one killed; and a
    ``SpeculativeTrainer`` round under ``torch.cuda.set_sync_debug_mode(
    "error")`` with the CPU's winner and validation losses within 1e-4."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.lifecycle import BranchStatus
    from repro_torch.data import SyntheticLMPipeline
    from repro_torch.explore_ctx import SpeculativeTrainer
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import FaultTolerantTrainer
    from repro_torch.runtime.train_loop import (
        build_train_step, init_train_state)

    lr = TRAIN_PARITY_LR
    for name, layers, b, s in TRAIN_PARITY:
        cfg = dataclasses.replace(get_config(name), dtype="float32",
                                  num_layers=layers or
                                  get_config(name).num_layers)
        model = Model(cfg, attn_chunk=64, loss_chunk=64)
        opt = adamw(lr)
        step = build_train_step(model, opt, accum_steps=2, clip_norm=1.0)
        state = init_train_state(model, opt,
                                 torch.Generator().manual_seed(0))
        runs = {}
        for dev in ("cpu", "cuda"):
            st = _state_to(state, dev)
            data = SyntheticLMPipeline(cfg, batch=b, seq=s, seed=1,
                                       device=dev)
            t0 = time.perf_counter()
            metrics = []
            for _ in range(3):
                st, met = step(st, data.next())
                metrics.append([float(met["loss"]), float(met["grad_norm"])])
            runs[dev] = (metrics, _to(st.params, "cpu"),
                         time.perf_counter() - t0)
            del st
        got, want = np.array(runs["cuda"][0]), np.array(runs["cpu"][0])
        pairs = list(zip(_leaves(runs["cuda"][1]), _leaves(runs["cpu"][1])))
        diffs = [(a - b_).abs() for a, b_ in pairs]
        worst = max(float(d.max()) for d in diffs)
        n = sum(d.numel() for d in diffs)
        mean = sum(float(d.sum()) for d in diffs) / n
        flipped = sum(int((d > 1e-5 * float(w.abs().max())).sum())
                      for d, (_, w) in zip(diffs, pairs))
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        log(f"{name} widths, {cfg.num_layers} layers, 3 train steps (AdamW "
            f"lr {lr}, clip 1.0, accum 2, b={b} s={s}): losses and grad "
            f"norms card {got.tolist()} cpu {want.tolist()}, max rel "
            f"{rel:.3g} (tol 1e-4); params {flipped} of {n} elements beyond "
            f"1e-5 of their leaf's largest magnitude (tol {n // 1000}), max "
            f"|cuda - cpu| {worst:.3g} (tol {2 * lr:.3g} = 2 lr), mean "
            f"{mean:.3g}; cpu {runs['cpu'][2]:.1f} s, card "
            f"{runs['cuda'][2]:.1f} s")
        if rel > 1e-4 or flipped > n // 1000 or worst > 2 * lr:
            fail(f"{name}: training on the card disagrees with the CPU")

    # the branch semantics of training, on the card (paper-agentic f32)
    cfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32")
    model = Model(cfg, attn_chunk=64, loss_chunk=64)
    opt = adamw(lr)
    step = build_train_step(model, opt, clip_norm=1.0)
    state = init_train_state(model, opt,
                             torch.Generator(device="cuda").manual_seed(0))

    def data(seed):
        return SyntheticLMPipeline(cfg, batch=4, seq=128, seed=seed,
                                   device="cuda")

    tr = FaultTolerantTrainer(step_fn=step, state=state, data=data(2),
                              corrupt_loss_at=2)
    tr.run(2)
    before = tr.committed_state
    snap = [x.clone() for x in _state_leaves(before)]
    tr.run(1)                                   # the injected NaN
    same = tr.committed_state is before and all(
        torch.equal(a, b_) for a, b_ in zip(_state_leaves(before), snap))
    tr.run(2)
    log(f"FaultTolerantTrainer on the card, NaN injected at step 2: "
        f"rollbacks {tr.rollbacks}, committed step "
        f"{int(tr.committed_state.step)}, committed state bit-identical "
        f"after the rollback: {same}")
    if not same or tr.rollbacks != 1 or int(tr.committed_state.step) != 4:
        fail("the NaN rollback changed the committed state")

    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        a = FaultTolerantTrainer(step_fn=step, state=state, data=data(3),
                                 ckpt=CheckpointManager(root), ckpt_every=4)
        a.run(4)
        a.ckpt = None
        b_tr = FaultTolerantTrainer.restore(step, state, data(3),
                                            CheckpointManager(root))
        batches_same = all(torch.equal(a.data.peek(i)["tokens"],
                                       b_tr.data.peek(i)["tokens"])
                           for i in (4, 5))
        restored, cursor = int(b_tr.state.step), b_tr.data.state().step
        a.run(2)
        b_tr.run(2)
        la = [m["loss"] for m in a.metrics_log[4:]]
        lb = [m["loss"] for m in b_tr.metrics_log]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"checkpoint at step 4 restored on the card: step {restored}, data "
        f"cursor {cursor}, batches identical {batches_same}, losses {lb} vs "
        f"uninterrupted {la}")
    if (restored != 4 or cursor != 4 or not batches_same
            or not np.allclose(lb, la, rtol=1e-5, atol=0)):
        fail("the restored trainer does not replay the stream")

    tr = FaultTolerantTrainer(step_fn=step, state=state, data=data(4))
    tr.run(1)
    res = tr.speculative_step(n_replicas=3, delays=[2.0, 0.0, 0.0],
                              kill=[False, False, True])
    log(f"speculative_step on the card (replica 0 delayed 2 s, replica 2 "
        f"killed): {res['outcomes']}, statuses "
        f"{[st.name for st in res['statuses']]}")
    if (res["outcomes"] != ["stale", "committed", "killed"]
            or res["statuses"] != [BranchStatus.STALE,
                                   BranchStatus.COMMITTED,
                                   BranchStatus.STALE]):
        fail("the straggler race did not commit the fast replica alone")

    keys = importlib.import_module("repro_torch.core.explore")
    spec = SpeculativeTrainer(model, adamw(1e-2), n_branches=4)
    params = model.init(torch.Generator().manual_seed(1))
    cpu_state = {"params": params, "opt": spec.opt.init(params)}
    pipe = SyntheticLMPipeline(cfg, batch=2, seq=128, seed=5, device="cpu")
    batch, val = pipe.next(), pipe.next()
    key = keys.key_from(11)
    rounds = {"cpu": spec.round(cpu_state, key, batch, val)}
    args = (_to(cpu_state, "cuda"), key.cuda(), _to(batch, "cuda"),
            _to(val, "cuda"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rounds["cuda"] = spec.round(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    winners = {d: int(r.winner) for d, r in rounds.items()}
    vals = {d: r.aux.cpu().tolist() for d, r in rounds.items()}
    rel = max(abs(a - b_) / abs(b_) for a, b_ in zip(vals["cuda"],
                                                     vals["cpu"]))
    # two branches that drew one multiplier tie: either may win
    cpu = vals["cpu"]
    tie = abs(cpu[winners["cuda"]] - cpu[winners["cpu"]]) \
        <= 1e-6 * abs(cpu[winners["cpu"]])
    log(f"SpeculativeTrainer round (4 branches) under sync debug mode "
        f"'error': winner card {winners['cuda']} cpu {winners['cpu']}"
        f"{' (a tie: one multiplier)' if winners['cuda'] != winners['cpu'] and tie else ''}, "
        f"val losses card {vals['cuda']} cpu {cpu} (max rel {rel:.3g}, "
        "tol 1e-4)")
    if (not tie or rel > 1e-4
            or vals["cuda"][winners["cuda"]] != min(vals["cuda"])):
        fail("the speculative trainer's round differs between card and CPU")
    torch.cuda.empty_cache()


#: phase 13's full-width runs: (config, batch, sequence)
TRAIN_CONFIGS = (("qwen2-1.5b", 4, 2048), ("mamba2-2.7b", 2, 2048))
TRAIN_STEPS = 8
TRAIN_NAN_AT = 3
PEAK_BF16 = PEAK_OPS_PER_S[torch.bfloat16]


def fingerprint(tree) -> torch.Tensor:
    """Every leaf's bits summed in int64, 2**24 elements at a time: equal
    fingerprints of one state before and after a step (with the same
    tensors, untouched version counters) say it was not written."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    sums = []
    for x in _state_leaves(tree):
        flat = x.reshape(-1).view(ints[x.element_size()])
        sums += [torch.sum(part, dtype=torch.int64)
                 for part in flat.split(1 << 24)]
    return torch.stack(sums).cpu()


@contextlib.contextmanager
def counted_train_calls():
    """Count the training forward's calls of K2 and K4 (the names
    ``models.layers`` and ``models.ssm`` bound at import), the remat
    recompute's included."""
    from repro_torch.models import layers, ssm

    sites = {"flash_attention": layers, "ssd_scan": ssm}
    calls = {name: 0 for name in sites}
    saved = {name: getattr(mod, name) for name, mod in sites.items()}

    def counting(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return saved[name](*args, **kwargs)
        return call
    for name, mod in sites.items():
        setattr(mod, name, counting(name))
    try:
        yield calls
    finally:
        for name, mod in sites.items():
            setattr(mod, name, saved[name])


def profile_train_step(run_step, step_ms: float, when_done=None,
                       cpu: bool = True) -> dict:
    """One training step under torch.profiler (after one traced warm-up
    step, dropped): its device-busy ms, K2's and K4's kernel ms, and the
    device ms under the two Functions' backward labels (the plain
    recompute backward).  The busy share divides the device-busy ms by
    ``step_ms``, an unprofiled step's wall time: the profiler's cost per
    host op stretches the profiled step's own wall time (a step of many
    small ops the most) but not the kernels' device time.  ``when_done``
    is called once the profiled step has finished on the card, before the
    host processes the trace (``trace_s``).  Without ``cpu`` the tracer
    records the card's activity only (no host ops, so no backward labels):
    a trace of far fewer events, for a step of very many host ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(
                     p.key_averages())) as prof:
        run_step()
        prof.step()
        t0 = time.perf_counter()
        run_step()
        wall_ms = (time.perf_counter() - t0) * 1e3
        if when_done is not None:
            when_done()
        t0 = time.perf_counter()
        prof.step()
        trace_s = round(time.perf_counter() - t0, 1)

    def device_ms(e, self_only):
        name = ("self_device_time_total" if self_only
                else "device_time_total")
        us = getattr(e, name, None)
        if us is None:
            us = getattr(e, name.replace("device", "cuda"), 0)
        return us / 1e3

    busy = k2 = k4 = 0.0
    # a label shows as a CPU range, whose device time is its kernels', and
    # as a GPU annotation spanning them, idle gaps included: read the
    # former, and count neither as a kernel
    labels = {"flash_attention.backward": 0.0, "ssd_scan.backward": 0.0}
    for e in traced[0]:
        if e.key in labels:
            if e.device_type == DeviceType.CPU:
                labels[e.key] += device_ms(e, False)
            continue
        if (e.device_type != DeviceType.CUDA
                or e.key.startswith("ProfilerStep")):
            continue
        ms = device_ms(e, True)
        busy += ms
        if "flash_attention" in e.key and "kernel" in e.key:
            k2 += ms
        if "ssd_scan" in e.key and "kernel" in e.key:
            k4 += ms
    if not busy:
        log("profile: device time not measured (no CUDA events)")
        return {"profiled_wall_ms": wall_ms, "device_busy_share": None,
                "trace_s": trace_s}
    return {"profiled_wall_ms": round(wall_ms, 1), "trace_s": trace_s,
            "device_busy_ms": round(busy, 1),
            "device_busy_share": round(busy / step_ms, 4),
            "k2_fwd_ms": round(k2, 2), "k4_fwd_ms": round(k4, 2),
            "k2_plain_bwd_ms": round(labels["flash_attention.backward"], 2)
            or None,
            "k4_plain_bwd_ms": round(labels["ssd_scan.backward"], 2) or None}


def model_flops(cfg, tokens: int, b: int, s: int) -> float:
    """6·N·tokens plus causal attention's score and value products
    (forward and backward, 3 x 2 x 2 x b x s^2/2 x h x hd per layer); the
    SSD scan's products are not counted."""
    attn = 0.0
    if cfg.num_heads:
        attn = 6.0 * b * s * s * cfg.num_heads * cfg.head_dim \
            * cfg.num_layers
    return 6.0 * cfg.param_count() * tokens + attn


def trainer_run(name: str, model, b: int, s: int, seed: int,
                when_done=None, profile_cpu: bool = True) -> dict:
    """``TRAIN_STEPS`` steps of one model through ``FaultTolerantTrainer``
    (no checkpoint manager): AdamW (``cosine_warmup``), clip 1.0, remat on,
    one injected NaN at ``TRAIN_NAN_AT`` that must roll back to a
    bit-identical committed state; every committed loss finite, the last
    below the first; K2/K4 launches equal to their calls, 2 per layer, mesh
    position and step (the remat recompute's included).  The weights come
    from the port's seeded init (over a plan, ``init_train_state`` stores
    the state as blocks, reported by :func:`stored_report`).  Returns the
    run's numbers,
    its first step's raw metrics and a profiled step (``when_done`` and
    ``profile_cpu`` as :func:`profile_train_step`'s ``when_done`` and
    ``cpu``)."""
    from repro_torch.data import SyntheticLMPipeline
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.runtime.fault import FaultTolerantTrainer
    from repro_torch.runtime.train_loop import (
        build_train_step, init_train_state)

    cfg = model.cfg
    card = card_line()
    positions = model.plan.dp_size * model.plan.tp_size
    opt = adamw(cosine_warmup(1e-3, 2, TRAIN_STEPS))
    step = build_train_step(model, opt, clip_norm=1.0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(
        model, opt, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    res = {"params_b": round(cfg.param_count() / 1e9, 3),
           "b": b, "s": s, "positions": positions,
           "init_s": round(time.perf_counter() - t0, 1),
           "init_peak_gb": round(torch.cuda.max_memory_allocated()
                                 / 1e9, 2)}
    if model.plan.is_distributed:
        res["stored"] = stored_report(state)
    tr = FaultTolerantTrainer(
        step_fn=step, state=state, data=SyntheticLMPipeline(
            cfg, batch=b, seq=s, seed=seed, device="cuda"),
        corrupt_loss_at=TRAIN_NAN_AT)
    del state
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    times, rollback_same = [], None
    with counted_train_calls() as calls:
        for i in range(TRAIN_STEPS):
            if i == TRAIN_NAN_AT:
                before = tr.committed_state
                fp = fingerprint(before)
                versions = [x._version for x in _state_leaves(before)]
            t1 = time.perf_counter()
            tr.run(1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            log(f"{name} step {i}: {times[-1]:.1f} ms, committed "
                f"{len(tr.metrics_log)}, rollbacks {tr.rollbacks}, "
                f"loss {tr.metrics_log[-1]['loss']:.4f}")
            if i == TRAIN_NAN_AT:
                after = tr.committed_state
                rollback_same = (
                    after is before and torch.equal(fingerprint(after), fp)
                    and versions == [x._version
                                     for x in _state_leaves(after)])
                del before, after
    launches = launch_counts()
    res["step_peak_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 2)
    losses = [m["loss"] for m in tr.metrics_log]
    attn_calls, ssd_calls = calls["flash_attention"], calls["ssd_scan"]
    res["launches"] = {"flash_attention": launches["flash_attention"],
                       "ssd_scan": launches["ssd_scan"]}
    res["calls"] = dict(calls)
    res["first"] = dict(tr.metrics_log[0])
    # the steady steps: not the first (lazy set-up) nor the rolled-back
    steady = [t for i, t in enumerate(times) if i not in (0, TRAIN_NAN_AT)]
    p50 = statistics.median(steady)
    tokens = b * s
    res.update(
        losses=[round(x, 4) for x in losses], rollbacks=tr.rollbacks,
        rollback_bit_identical=rollback_same,
        step_ms=[round(t, 1) for t in times], step_ms_p50=round(p50, 1),
        tokens_per_s=round(tokens / p50 * 1e3),
        model_flop_share=round(model_flops(cfg, tokens, b, s)
                               / (p50 / 1e3) / PEAK_BF16, 4))
    n_attn = cfg.num_layers * positions if cfg.num_heads else 0
    n_ssd = cfg.num_layers * positions if cfg.family == "ssm" else 0
    res["profile"] = profile_train_step(
        lambda: (tr.run(1), torch.cuda.synchronize()), p50, when_done,
        cpu=profile_cpu)
    log(f"{name} b={b} s={s}: {json.dumps(res)} ({card})")
    if (not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS - 1
            or not losses[-1] < losses[0]):
        fail(f"{name}: training did not commit finite, falling losses: "
             f"{losses}")
    if tr.rollbacks != 1 or not rollback_same:
        fail(f"{name}: the injected NaN did not roll back to a "
             "bit-identical committed state")
    if (launches["flash_attention"] != attn_calls
            or launches["ssd_scan"] != ssd_calls
            or attn_calls != 2 * n_attn * TRAIN_STEPS
            or ssd_calls != 2 * n_ssd * TRAIN_STEPS):
        fail(f"{name}: K2/K4 launches {res['launches']} for calls "
             f"{calls} (2 per layer, position and step with remat "
             "expected)")
    # the trainer's store and its branch tree refer to each other
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return res


def stored_report(state) -> dict:
    """Phase 15 (f): a state stored as blocks: the bytes of its parameters
    and moments per distinct device, their sum against the whole tree's
    bytes, and the stored tensors larger than their block (a view of a
    larger tensor, or a block of the wrong shape): none may be."""
    from repro_torch.distributed import blocked

    tree = (state.params, state.opt_state)
    per_device = blocked.stored_bytes(tree)
    leaves = blocked.leaves(tree)
    whole = sum(x.numel() * x.dtype.itemsize for x in leaves)
    larger = 0
    for x in leaves:
        parts = (zip((r for r, _ in x.sharding.blocks(x.shape)), x.blocks)
                 if blocked.is_blocked(x) else [(None, x)])
        for region, t in parts:
            larger += (t.untyped_storage().nbytes()
                       > t.numel() * t.element_size()
                       or (region is not None
                           and list(t.shape) != [n for _, n in region]))
    return {"bytes_per_device": {str(d): v for d, v in per_device.items()},
            "whole_bytes": whole, "sum_equal": sum(per_device.values())
            == whole, "blocked_leaves": sum(map(blocked.is_blocked, leaves)),
            "leaves": len(leaves), "larger_than_block": larger}


def phase_train(seed: int = 0) -> dict:
    """Phase 13: training at full width and depth in bf16, random weights
    from the port's init, one config at a time (each freed before the
    next), through :func:`trainer_run`.  The training CLI runs as a
    subprocess started once mamba2's profiled step has finished."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    log(f"== phase 13: training at full width and depth, bf16, random "
        f"weights ({card_line()})")
    gc.collect()
    out = {}
    cli = []
    for i, (name, b, s) in enumerate(TRAIN_CONFIGS):
        # the CLI starts once the last run's profiled step has finished on
        # the card, beside the host's processing of that trace; the cached
        # blocks of the run's step (its peak, 64.7 GB for mamba2) go back
        # to the card first, for the CLI's process
        last = i == len(TRAIN_CONFIGS) - 1
        try:
            out[name] = trainer_run(
                name, Model(get_config(name)), b, s, seed,
                when_done=(lambda: (torch.cuda.empty_cache(),
                                    cli.append(train_cli_start())))
                if last else None)
        except BaseException:
            if cli:
                cli[0][0].kill()
            raise
    out["cli"] = train_cli_finish(cli[0])
    return out


#: the training CLI's steps in phases 13 and 15 (cut from 20 to keep the
#: whole script near half its time limit)
CLI_STEPS = 8


def train_cli_start(distributed: bool = False) -> tuple:
    """Start ``python -m repro_torch.launch.train --arch paper-agentic
    --steps 8`` as a subprocess (its own checkpoint directory); with
    ``distributed``, ``--distributed`` too, whose first line says how it
    placed the run (one card: single-device).  :func:`train_cli_finish`
    waits for it."""
    root = tempfile.mkdtemp(prefix="chip-smoke-train-")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "paper-agentic", *(["--distributed"] if distributed else []),
           "--steps", str(CLI_STEPS), "--ckpt-dir", root]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=src_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, cmd, root, distributed, time.perf_counter()


def train_cli_finish(started: tuple) -> dict:
    """Wait for :func:`train_cli_start`'s run (killed after 600 s), remove
    its checkpoint directory and check it finished its steps."""
    proc, cmd, root, distributed, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    secs = time.perf_counter() - t0
    steps = CLI_STEPS
    lines = out.strip().splitlines()
    last = lines[-1] if lines else ""
    placed = lines[0] if distributed and len(lines) > 1 else ""
    log(f"{' '.join(cmd[1:-2])}: exit {proc.returncode} in {secs:.1f} s: "
        f"{(placed + ' / ') if placed else ''}{last!r}")
    if (proc.returncode != 0
            or not last.startswith(f"done: step {steps} loss ")
            or (distributed and not placed.startswith(
                ("training mesh:", "--distributed with one visible")))):
        log(err[-4000:])
        fail(f"the training CLI did not finish its {steps} steps")
    return {"exit": proc.returncode, "s": round(secs, 1), "line": last,
            **({"placed": placed} if distributed else {})}


def train_timing(gen, timer, train: dict) -> None:
    """Phase 10's training rows at phase 13's shapes, bf16: K2 at
    qwen2-1.5b's (b 4, s 2048, h 12, kv 2, hd 128; chunk 1024) and K4 at
    mamba2-2.7b's (b 2, s 2048, H 80, P 64, N 128): the kernel forward
    beside the plain forward and the plain recompute backward (the
    Functions' backward bodies), and for K2 SDPA's forward + backward."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_vjp
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.layers import chunked_attention_vjp

    bf16 = torch.bfloat16
    rows = {}
    (_, b, s), (_, b4, s4) = TRAIN_CONFIGS
    q, k, v, g = (torch.randn(b, s, n, 128, generator=gen,
                              device="cuda").to(bf16) for n in (12, 2, 2, 12))
    c = compare(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    if not c["ok"]:
        fail(f"K2 at phase 13's shape: {tol_text(c, bf16)}")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gt = g.transpose(1, 2)

    def sdpa():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        torch.autograd.grad(o, (qt, kt, vt), gt)
    bnd, by = bound_ms(*flash_cost(q, k), bf16)
    rows[f"K2 training b={b} s={s}"] = dict(
        ms=timer(lambda: flash_attention(q, k, v)),
        plain_ms=timer(lambda: flash_attention_ref(q, k, v), 5),
        plain_bwd_ms=timer(lambda: chunked_attention_vjp(q, k, v, g,
                                                         chunk=1024), 5),
        library_fwd_bwd_ms=timer(sdpa), bound_ms=bnd, bound_by=by,
        launches=train["qwen2-1.5b"]["launches"]["flash_attention"],
        max_abs_err=c["max_abs_err"])
    args = ssd_case(gen, s=s4, b=b4)
    y_ref, st_ref = ssd_scan_ref(*args)
    y, st = ssd_scan(*args)
    cy, cs = compare(y, y_ref), compare(st, st_ref)
    if not (cy["ok"] and cs["ok"]):
        fail(f"K4 at phase 13's shape: y {tol_text(cy, bf16)}; state "
             f"{tol_text(cs, torch.float32)}")
    gy = torch.randn(y.shape, generator=gen, device="cuda").to(bf16)
    bnd, by = bound_ms(*ssd_cost(args[0], args[3]), bf16)
    rows[f"K4 training b={b4} s={s4}"] = dict(
        ms=timer(lambda: ssd_scan(*args)),
        plain_ms=timer(lambda: ssd_scan_ref(*args), 5),
        plain_bwd_ms=timer(lambda: ssd_scan_vjp(*args, gy, None), 5),
        library_fwd_bwd_ms=None, bound_ms=bnd, bound_by=by,
        launches=train["mamba2-2.7b"]["launches"]["ssd_scan"],
        max_abs_err=max(cy["max_abs_err"], cs["max_abs_err"]))
    for label, r in rows.items():
        log(f"{label}: kernel forward {r['ms']:.4f} ms, plain forward "
            f"{r['plain_ms']:.4f} ms, plain recompute backward "
            f"{r['plain_bwd_ms']:.4f} ms, sdpa forward + backward "
            f"{r['library_fwd_bwd_ms'] if r['library_fwd_bwd_ms'] is None else round(r['library_fwd_bwd_ms'], 4)} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['launches']} launches in phase 13")
    log("training kernel rows: " + json.dumps(rows))


# ---------------------------------------------------------------------------
# phase 14: tensor-parallel serving, every shard on the one card
# ---------------------------------------------------------------------------

#: float32 card against float32 (the card's kernels, the CPU's plain
#: versions, one shard against two): summation order through 2 layers, as
#: phase 5's states
TP_F32_TOL = 1e-4
#: bf16 logits of tp 2 against tp 1 at full depth: each of the 56
#: sublayers adds its two shards' bf16 partial products where tp 1 rounds
#: one product, so the hidden states drift by about an ulp (2**-8..2**-7)
#: a sublayer; a missing or doubled shard is an O(1) error
TP_BF16_REL_RMS = 2 ** -5
#: phase 14's verify: four drafts of four tokens
TP_DRAFTS = [[1, 2, 3, 4], [4, 3, 2, 1], [7, 7, 7, 7], [9, 8, 7, 6]]
#: phase 14 (c): qwen3-moe-235b-a22b cut to this many of its 94 layers
TP_MOE_LAYERS = 6
#: phase 14 (d): dbrx-132b cut to this many of its 40 layers (28.5 GB in
#: bf16: the whole tree and its shards fit one card together)
TP_DBRX_LAYERS = 4
#: the share of the first routing call's rows tp 4 must route as tp 1: the
#: router's input differs by the f32 order of the attention partials' sum
#: (rounded once), so a row flips only where two experts' scores tie
#: within it; bf16 partials summed in bf16 flipped 4% of them on an H100
#: (``tools/tp_partials.py``)
TP_ROUTED_AS_TP1 = 0.99
#: phase 14 (d)'s gate on the first step's logits reads the rows routed as
#: tp 1 routes them at every routing call of the step, at a capacity that
#: drops no row (:func:`no_drop`): at least this share of the batch
TP_ROWS_ALIKE = 0.5


@contextlib.contextmanager
def pass_logits(method: str, limit: int | None = None):
    """Record, on the host, the logits of the first ``limit`` calls of
    ``ServeEngine.<method>`` (a verify pass, or a decode step)."""
    from repro_torch.runtime import ServeEngine

    real, seen = getattr(ServeEngine, method), []

    def recording(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        if isinstance(out, torch.Tensor) and (limit is None
                                              or len(seen) < limit):
            seen.append(out.float().cpu())
        return out
    setattr(ServeEngine, method, recording)
    try:
        yield seen
    finally:
        setattr(ServeEngine, method, real)


def tp_cycle(eng) -> dict:
    """``tests/test_distributed.py``'s tp serving cycle: decode, fork 2
    (lazy CoW: faults on the next step), 3 steps, a 4x4 verify, commit
    (the sibling invalidated), one step."""
    sid = eng.add_request([1, 2, 3, 4, 5])
    toks = [eng.decode([sid])]
    kids = eng.fork(sid, 2)
    for _ in range(3):
        toks.append(eng.decode(kids))
    rows = eng.spec_verify(kids[1], TP_DRAFTS)
    parent = eng.commit(kids[0])
    toks.append(eng.decode([parent]))
    return {"tokens": toks, "rows": rows,
            "cow": (eng.cow_dispatches, eng.cow_faults,
                    eng.cow_inline_steps)}


def tp_parity() -> None:
    """Phase 14 (a), the hard gate: ``paper-agentic`` at 2 layers in f32
    through the cycle at tp 2 on the card (both shards on cuda:0, kv 2
    each), at tp 1 on the card and at tp 2 on the CPU, on the fused,
    ``"ref"`` and int8 paths: identical greedy tokens, verify rows and CoW
    counts, the verify logits within ``TP_F32_TOL``; then a small MoE
    config the same way, identical expert ids at every routing call (each
    of tp 2's two shards routes every row as tp 1 does)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import Model
    from repro_torch.runtime import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = (("tp2 card", dict(tp=2, device="cuda:0")),
            ("tp1 card", dict(device="cuda:0")),
            ("tp2 cpu", dict(tp=2, device="cpu")))
    geometry = dict(num_pages=64, page_size=4, max_pages_per_seq=16)
    cfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32",
                              num_layers=2)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    for path, kw in (("fused", {}), ("ref", {"attn_impl": "ref"}),
                     ("int8", {"kv_dtype": "int8"})):
        out = {}
        for label, ekw in runs:
            zero_launches()
            with pass_logits("_chunk_pass") as logits:
                eng = ServeEngine(model, params, **geometry, **kw, **ekw)
                out[label] = tp_cycle(eng)
            out[label]["verify"] = logits[-1]
            if label == "tp2 card":
                log(f"tp {eng.tp} over [{', '.join(map(str, eng.devices))}]"
                    f" ({path} path, kv {eng.shards[0].k_pages.shape[3]} "
                    "a shard)")
                launches = launch_counts()
                step = "paged_attention" if path == "ref" else \
                    "paged_chunk_attention"
                if not (launches[step] and launches["flash_attention"]):
                    fail(f"phase 14 ({path}): a kernel of the tp path never "
                         f"launched: {launches}")
        want = out["tp1 card"]
        for label in ("tp2 card", "tp2 cpu"):
            got = out[label]
            err = (got["verify"] - want["verify"]).abs()
            close = bool(err.le(
                TP_F32_TOL + TP_F32_TOL * want["verify"].abs()).all())
            same = (got["tokens"], got["rows"], got["cow"]) == (
                want["tokens"], want["rows"], want["cow"])
            log(f"paper-agentic 2 layers f32 {path}: {label} vs tp1 card: "
                f"tokens, verify rows and CoW counts {got['cow']} identical"
                f"={same}; verify logits max_abs_err "
                f"{err.max().item():.3g} (tol {TP_F32_TOL} + {TP_F32_TOL}"
                f"*|ref|) {'ok' if close else 'MISMATCH'}")
            if not (same and close):
                fail(f"phase 14 ({path}): {label} differs from tp 1 on the "
                     f"card: {got['tokens']} {got['rows']} {got['cow']} vs "
                     f"{want['tokens']} {want['rows']} {want['cow']}")
    mcfg = dataclasses.replace(
        reduced(get_config("qwen3-moe-235b-a22b"), d_model=128),
        dtype="float32", num_kv_heads=2, num_layers=2)
    model = Model(mcfg)
    params = model.init(torch.Generator().manual_seed(0))
    out = {}
    for label, ekw in runs:
        with routed_experts() as ids:
            eng = ServeEngine(model, params, **geometry, **ekw)
            out[label] = tp_cycle(eng)
        out[label]["ids"] = ids
    one = out["tp1 card"]["ids"]
    # tp 2 routes each call twice, once per shard, each as tp 1 does
    pairs = [x for x in one for _ in range(2)]
    for label in ("tp2 card", "tp2 cpu"):
        got = out[label]
        same = got["tokens"] == out["tp1 card"]["tokens"]
        routed = got["ids"] == pairs
        log(f"{mcfg.name} reduced (E {mcfg.num_experts}, top "
            f"{mcfg.experts_per_token}, 2 layers) f32: {label} vs tp1 card: "
            f"greedy tokens identical={same}, expert ids identical={routed} "
            f"({len(got['ids'])} routing calls against {len(one)})")
        if not (same and routed):
            fail(f"phase 14 MoE: {label} differs from tp 1 on the card")


def first_step_logits(model, params, seed: int,
                      lens=DENSE_PROMPTS) -> torch.Tensor:
    """tp 1's first fused decode step of phase 3's load (phase 11's with
    ``lens=FAMILY_PROMPTS``; the logits of its branches), for phase 14 (b)
    and (d) to hold tp 2's and tp 4's against."""
    from repro_torch.runtime import ServeEngine

    eng = ServeEngine(model, params, page_size=16, num_pages=2048,
                      max_pages_per_seq=128, prefix_cache=True,
                      device="cuda:0")
    prompts = dense_prompts(model.cfg, lens, np.random.default_rng(seed))
    roots = [eng.add_request(p) for p in prompts]
    batch = [b for r in roots for b in eng.fork(r, 4)]
    with pass_logits("_fused_decode_step", limit=1) as seen:
        eng.decode(batch)
    for r in roots:
        eng.release(r)
    return seen[0]


def no_drop(cfg):
    """``cfg`` at the capacity factor ``E/K``: ``C = n`` slots an expert,
    so no expert drops a row (a row takes an expert once).  At the
    config's factor a decode step's rows share an expert's few slots, and
    one row routed apart moves which of the others are dropped."""
    return dataclasses.replace(
        cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)


def first_step_routed(model, params, seed: int, lens, **engine):
    """:func:`first_step_logits` through an engine made with ``engine``
    (``tp=4, device="cuda:0"``: placed shards): the first fused step's
    logits and the expert ids of every routing call inside that step (at
    tp > 1 one call a shard, in shard order)."""
    from repro_torch.runtime import ServeEngine

    eng = ServeEngine(model, params, page_size=16, num_pages=2048,
                      max_pages_per_seq=128, prefix_cache=True,
                      **({"device": "cuda:0"} | engine))
    prompts = dense_prompts(model.cfg, lens, np.random.default_rng(seed))
    roots = [eng.add_request(p) for p in prompts]
    batch = [b for r in roots for b in eng.fork(r, 4)]
    with pass_logits("_fused_decode_step", limit=1) as seen, \
            routed_experts() as ids:
        eng.decode(batch)
    for r in roots:
        eng.release(r)
    return seen[0], ids


def rows_routed_alike(calls, one_calls, shards: int) -> list:
    """For each row of a step, whether its expert ids equal tp 1's
    (``one_calls``, one call a layer) at every routing call; ``calls``
    holds ``shards`` calls a layer, which must agree."""
    layers = [calls[i:i + shards] for i in range(0, len(calls), shards)]
    if len(layers) != len(one_calls) or any(
            c != layer[0] for layer in layers for c in layer):
        fail(f"a step's {len(calls)} routing calls over {shards} shards "
             f"are not {len(one_calls)} layers' calls routed alike")
    return [all(layer[0][r] == one[r] for layer, one in zip(layers,
                                                           one_calls))
            for r in range(len(one_calls[0]))]


def phase_tp(seed: int = 0) -> dict:
    """Phase 14: tensor-parallel serving with both shards on cuda:0 (the
    script needs one card): (a) the f32 hard gate, (b) qwen2-1.5b
    at full width and depth in bf16 at tp 2 through phase 3's load on the
    fused path (its first step's logits against tp 1's) and 4 steps of
    the ``"ref"`` path, (c) qwen3-moe-235b-a22b at full width, cut to
    ``TP_MOE_LAYERS`` layers, at tp 2 (64 experts a shard) through phase
    11's load: the expert-parallel block against one device's on one
    input (``ep_gate``), and the two shards' ids at the first routing
    call, with the share of its rows routed as tp 1 routes them."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime import ServeEngine

    log("== phase 14: tensor-parallel serving on one card, tp 2 over "
        "[cuda:0, cuda:0]")
    card = card_line()
    tp_parity()
    out = {}

    # --- (b) qwen2-1.5b at full width and depth, bf16, tp 2 ---------------
    cfg = get_config("qwen2-1.5b")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    one = first_step_logits(model, params, seed)
    with pass_logits("_fused_decode_step", limit=1) as seen:
        fused = serve_dense(model, params, attn_impl="auto", steps=32,
                            seed=seed, tp=2)
    legacy = serve_dense(model, params, attn_impl="ref", steps=4, seed=seed,
                         tp=2)
    two = seen[0]
    rel = ((two - one).square().mean().sqrt()
           / one.square().mean().sqrt()).item()
    agree = (two.argmax(-1) == one.argmax(-1)).float().mean().item()
    log(f"qwen2-1.5b bf16 first step at tp 2 vs tp 1 (b=32, V "
        f"{cfg.vocab_size}): relative RMS error {rel:.3g} (gate "
        f"{TP_BF16_REL_RMS:.3g}), max abs error "
        f"{(two - one).abs().max().item():.3g} (max |tp1| "
        f"{one.abs().max().item():.3g}), greedy tokens agree on "
        f"{agree:.3f} of rows ({card})")
    if not rel <= TP_BF16_REL_RMS:
        fail("phase 14 (b): tp 2's first-step logits are not tp 1's within "
             "bf16 tolerance")
    fused["first_step_rel_rms"] = rel
    fused["first_step_argmax_agree"] = agree
    out["qwen2-1.5b"] = {"fused": fused, "ref": legacy}
    del params
    torch.cuda.empty_cache()

    # --- (c) qwen3-moe-235b-a22b, full width, cut depth, tp 2 -------------
    name = "qwen3-moe-235b-a22b"
    cfg = dataclasses.replace(get_config(name), num_layers=TP_MOE_LAYERS)
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    prompt = dense_prompts(cfg, FAMILY_PROMPTS,
                           np.random.default_rng(seed))[0]
    ep_gate(cfg, params, prompt)
    with routed_experts(limit=1) as ids1:
        eng = ServeEngine(model, params, page_size=16, num_pages=256,
                          max_pages_per_seq=128, device="cuda:0")
        eng.add_request(prompt)
    del eng
    with routed_experts(limit=2) as ids2:
        res = serve_dense(model, params, attn_impl="auto", steps=16,
                          lens=FAMILY_PROMPTS, seed=seed, tp=2)
    same = sum(a == b for a, b in zip(ids2[0], ids1[0])) / len(ids1[0])
    log(f"{name} ({TP_MOE_LAYERS} of 94 layers) tp 2, the first routing "
        f"call ({len(ids1[0])} rows x {cfg.experts_per_token}): the two "
        f"shards' expert ids identical={ids2[0] == ids2[1]}; rows whose ids "
        f"equal tp 1's {same:.4f} (the router's input already differs by "
        f"the bf16 sum of the attention over shards); max allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})")
    if ids2[0] != ids2[1]:
        fail(f"phase 14 (c): {name}'s shards routed the same rows apart")
    res["layers"] = TP_MOE_LAYERS
    res["first_call_rows_as_tp1"] = same
    res["max_allocated_gb"] = round(torch.cuda.max_memory_allocated() / 1e9,
                                    2)
    out[name] = {"fused": res}
    del params
    torch.cuda.empty_cache()
    out["dbrx-132b"] = {"fused": tp4_dbrx(seed)}
    return out


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tp4_dbrx(seed: int = 0) -> dict:
    """Phase 14 (d): dbrx-132b at full width, cut to ``TP_DBRX_LAYERS``
    layers, at tp 4 with every shard on cuda:0 (12 heads over 2 kv heads
    and 4 experts a shard: the shapes its serving over four cards gives K1
    and K2), its weights drawn shard by shard (``Model.init(generator,
    shards=plan)``): they must equal the whole init's slices bit for bit.
    Layer 0's MoE block over the 4 shards must be one device's on one
    input (:func:`ep_gate`).  Then phase 11's load through the engine
    given the placed shards: the four shards route the first call's rows
    alike, and at least ``TP_ROUTED_AS_TP1`` of them as tp 1 does.  The
    first step's logits are gated at a capacity that drops no row
    (:func:`no_drop`): the rows routed as tp 1 routes them at every call
    of the step (at least ``TP_ROWS_ALIKE`` of them) within
    ``TP_BF16_REL_RMS`` of tp 1's.  At the config's capacity they are
    printed, not gated: at b 16 each expert keeps 5 slots, so one row
    routed apart in a layer moves which rows the later layers drop
    (relative RMS 0.013-0.12 over three seeds at 4 layers on an H100:
    ``tools/tp_partials.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import serving_mesh, serving_plan
    from repro_torch.distributed.sharding import serve_specs, shard_leaf
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config("dbrx-132b"),
                              num_layers=TP_DBRX_LAYERS)
    model = Model(cfg)
    card = card_line()
    whole = model.init(torch.Generator(device="cuda").manual_seed(seed))
    with routed_experts(limit=1) as ids1:
        one = first_step_logits(model, whole, seed, FAMILY_PROMPTS)
    loose = Model(no_drop(cfg))
    one_open, one_calls = first_step_routed(loose, whole, seed,
                                            FAMILY_PROMPTS)
    ep_gate(cfg, whole, dense_prompts(cfg, FAMILY_PROMPTS,
                                      np.random.default_rng(seed))[0],
            shards=4)
    plan = serving_plan(serving_mesh(4, ["cuda:0"] * 4))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shards = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        shards=plan)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated() - before
    stored = torch.cuda.memory_allocated() - before
    specs = serve_specs(cfg, plan, whole)
    unequal = [path for rank, tree in enumerate(shards)
               for path, x in _paths(tree)
               if not torch.equal(x, shard_leaf(
                   _at(whole, path), _at(specs, path), "tp", rank, 4,
                   x.device))]
    whole_gb = sum(x.nbytes for _, x in _paths(whole)) / 1e9
    log(f"dbrx-132b ({TP_DBRX_LAYERS} of 40 layers) drawn shard by shard "
        f"at tp 4 in {init_s:.1f} s: {stored / 1e9:.2f} GB stored for a "
        f"{whole_gb:.2f} GB tree, the draw's peak {draw_peak / 1e9:.2f} GB "
        f"above it; leaves unequal to the whole init's slices: "
        f"{unequal or 'none'}")
    if unequal:
        fail("phase 14 (d): the shard-drawn weights are not the whole "
             "init's slices")
    del whole
    torch.cuda.empty_cache()
    with routed_experts(limit=4) as ids4, \
            pass_logits("_fused_decode_step", limit=1) as seen:
        res = serve_dense(model, shards, attn_impl="auto", steps=16,
                          lens=FAMILY_PROMPTS, seed=seed, tp=4)
    four = seen[0]
    rel = ((four - one).square().mean().sqrt()
           / one.square().mean().sqrt()).item()
    agree = (four.argmax(-1) == one.argmax(-1)).float().mean().item()
    same = sum(a == b for a, b in zip(ids4[0], ids1[0])) / len(ids1[0])
    log(f"dbrx-132b ({TP_DBRX_LAYERS} layers) bf16 first step at tp 4 vs tp "
        f"1 (b=16): relative RMS error {rel:.3g}, greedy tokens agree on "
        f"{agree:.3f} of rows; the first routing call ({len(ids1[0])} rows "
        f"x {cfg.experts_per_token}): the four shards alike="
        f"{all(x == ids4[0] for x in ids4)}, rows as tp 1 {same:.4f} (gate "
        f"{TP_ROUTED_AS_TP1}) ({card})")
    if same < TP_ROUTED_AS_TP1 or any(x != ids4[0] for x in ids4):
        fail("phase 14 (d): tp 4 routed the first call's rows apart from tp "
             "1, or its shards routed them apart from each other")
    four_open, four_calls = first_step_routed(loose, shards, seed,
                                              FAMILY_PROMPTS, tp=4)
    alike = rows_routed_alike(four_calls, one_calls, 4)
    rows = [r for r, a in enumerate(alike) if a]
    rel_alike = rel_rms(four_open[rows], one_open[rows]) if rows else \
        float("inf")
    rel_open = rel_rms(four_open, one_open)
    log(f"dbrx-132b ({TP_DBRX_LAYERS} layers) at capacity factor "
        f"{loose.cfg.moe_capacity_factor:g} (no row dropped), first step at "
        f"tp 4 vs tp 1: {len(rows)} of {len(alike)} rows routed alike at "
        f"all {len(one_calls)} routing calls (gate {TP_ROWS_ALIKE:g} of "
        f"them), their relative RMS error {rel_alike:.3g} (gate "
        f"{TP_BF16_REL_RMS:.3g}); every row {rel_open:.3g} ({card})")
    if not (len(rows) >= TP_ROWS_ALIKE * len(alike)
            and rel_alike <= TP_BF16_REL_RMS):
        fail("phase 14 (d): tp 4's first-step logits are not tp 1's within "
             "bf16 tolerance on the rows routed alike, at a capacity that "
             "drops no row")
    res.update(layers=TP_DBRX_LAYERS, first_step_rel_rms=rel,
               first_step_argmax_agree=agree, first_call_rows_as_tp1=same,
               no_drop_rows_alike=len(rows),
               no_drop_alike_rel_rms=rel_alike,
               no_drop_rel_rms=rel_open,
               shard_draw_s=round(init_s, 1),
               shard_draw_peak_gb=round(draw_peak / 1e9, 2))
    del shards
    torch.cuda.empty_cache()
    return res


def ep_gate(cfg, params, prompt, shards: int = 2) -> None:
    """Phase 14 (c)'s and (d)'s hard gate on the expert-parallel branch at
    full width: layer 0's MoE block on the first prompt's normed
    embeddings, ``moe_block`` over a ``shards``-way mesh on cuda:0
    (qwen3-moe's 64 experts a shard at 2, dbrx's 4 at 4) against one
    device, on the same input: identical expert ids at every routing call
    (each shard routes every row), the output within ``TOL``."""
    from repro_torch.distributed import serving_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models.transformer import embed_tokens

    lp = L.layer_params(params["layers"], 0)
    tokens = torch.tensor(prompt, device="cuda")[None]
    x = L.rms_norm(embed_tokens(cfg, params, tokens), lp["ln2"],
                   cfg.norm_eps)
    with routed_experts() as one_ids:
        one, _ = moe.moe_block(cfg, lp["moe"], x)
    with routed_experts() as ep_ids:
        ep, _ = moe.moe_block(cfg, lp["moe"], x, tp_axis="tp",
                              mesh=serving_mesh(shards, ["cuda:0"] * shards))
    c = compare(ep, one)
    routed = ep_ids == one_ids * shards
    log(f"{cfg.name} layer 0 MoE ({x.shape[1]} rows, E {cfg.num_experts}, "
        f"top {cfg.experts_per_token}, bf16): expert-parallel over {shards} "
        f"shards vs one device: expert ids identical={routed} ({len(ep_ids)} "
        f"routing calls against {len(one_ids)}), output "
        f"{tol_text(c, torch.bfloat16)}")
    if not (routed and c["ok"]):
        fail(f"phase 14: {cfg.name}'s expert-parallel MoE block over "
             f"{shards} shards differs from one device's")


def tp_timing(gen, timer, tp: dict) -> list:
    """Phase 10's rows at phase 14's per-shard shapes (bf16, page 16),
    each kernel held against its plain version first: K1 at qwen2-1.5b's
    tp 2 decode (b=32, kv 1, g 6), K3 at its ``"ref"`` decode, K2 at its
    prefill (h 6 over kv 1, s 1023) beside SDPA, K1 at
    qwen3-moe-235b-a22b's tp 2 decode (kv 2, g 16), and dbrx-132b's tp 4
    shapes: K1 at its decode (b=16, kv 2, g 6) and K2 at its longest
    prompt (h 12 over kv 2, s 1024) beside SDPA.  Launches: phase 14's."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_chunk_attention)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_chunk_attention_ref)

    bf16 = torch.bfloat16
    src = "src/repro_torch/kernels/paged_attention/csrc/" \
          "paged_chunk_attention.cu"
    rows = []
    for label, name, path, kv, g in (
            ("K1 qwen2-1.5b tp 2 decode", "qwen2-1.5b", "fused", 1, 6),
            ("K3 qwen2-1.5b tp 2 decode", "qwen2-1.5b", "ref", 1, 6),
            ("K1 qwen3-moe-235b-a22b tp 2 decode", "qwen3-moe-235b-a22b",
             "fused", 2, 16),
            ("K1 dbrx-132b tp 4 decode", "dbrx-132b", "fused", 2, 6)):
        res = tp[name][path]
        width = 4 if name == "dbrx-132b" else 2
        lengths = res["decode_lengths"]
        case = paged_case(gen, b=len(lengths), t=1, kv=kv, g=g, hd=128,
                          page=16, lengths=lengths, dtype=bf16)
        if path == "ref":
            case = cached_case(case)
            fn, ref_fn, cost = (paged_attention, paged_attention_ref,
                                cached_cost)
            kernel, replaces = "paged_attention", "kernel.py:114"
        else:
            fn, ref_fn, cost = (paged_chunk_attention,
                                paged_chunk_attention_ref, paged_cost)
            kernel, replaces = "paged_chunk_attention", "kernel.py:260"
        c = compare(fn(**case), ref_fn(**case))
        if not c["ok"]:
            fail(f"{label}: {kernel} disagrees with its plain version "
                 f"({tol_text(c, bf16)})")
        ms = timer(lambda: fn(**case))
        plain = timer(lambda: ref_fn(**case), 5)
        bnd, by = bound_ms(*cost(case), bf16)
        launches = res["launches"][kernel]
        log(f"{label} b={len(lengths)} kv={kv} g={g} (lengths "
            f"{min(lengths)}-{max(lengths)}): {tol_text(c, bf16)}; kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}), "
            f"{launches} launches in phase 14")
        rows.append({
            "name": f"{kernel} (tp {width} shard: {name}, kv {kv}, g {g})",
            "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/paged_attention/{replaces}",
            "launches": launches, "max_abs_err": c["max_abs_err"],
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None})
    # K2 at qwen2-1.5b's tp 2 shard (phase 14's tp 2 launches) and at
    # dbrx-132b's tp 4 shard, its longest prompt (14 (d)'s)
    for label, s, h, kv, names in (
            ("tp 2 shard: qwen2-1.5b", 1023, 6, 1,
             ("qwen2-1.5b", "qwen3-moe-235b-a22b")),
            ("tp 4 shard: dbrx-132b", 1024, 12, 2, ("dbrx-132b",))):
        q, k, v = flash_case(gen, s=s, h=h, kv=kv)
        c = compare(flash_attention(q, k, v), flash_attention_ref(q, k, v))
        if not c["ok"]:
            fail(f"K2 at the {label}: {tol_text(c, bf16)}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = timer(lambda: flash_attention(q, k, v))
        plain = timer(lambda: flash_attention_ref(q, k, v), 5)
        lib = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bnd, by = bound_ms(*flash_cost(q, k), bf16)
        launches = sum(tp[n][p]["launches"]["flash_attention"]
                       for n in names for p in tp[n])
        log(f"K2 {label} h={h} kv={kv} s={s}: {tol_text(c, bf16)}; "
            f"kernel {ms:.4f} ms, sdpa {lib:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}), {launches} launches in phase 14")
        rows.append({
            "name": f"flash_attention ({label}, h {h}, kv {kv})",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
            "launches": launches, "max_abs_err": c["max_abs_err"],
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib})
    return rows


# ---------------------------------------------------------------------------
# phase 15: training over a (data, model) mesh, every position on the card
# ---------------------------------------------------------------------------

#: phase 15's mesh: (data, model) positions, all on cuda:0
DIST_SHAPE = (2, 2)
#: phase 15 (b) against phase 13's first step (same weights and batch),
#: bf16: each of the 56 sublayers adds its two model positions' bf16
#: partials where one device rounds one product, and the gradients sum
#: over the data positions in f32 and round once (one device: once); a
#: missing or doubled position is an O(1) error
DIST_BF16_LOSS_REL = 2 ** -7
DIST_BF16_GNORM_REL = 2 ** -5


def card_plan(n: int, prefer_model: int):
    """``plan_mesh`` over ``n`` positions, every one cuda:0."""
    from repro_torch.runtime.elastic import plan_mesh

    return plan_mesh(["cuda:0"] * n, prefer_model=prefer_model)


def dist_steps(model, state, batches) -> tuple:
    """Three AdamW steps (lr ``TRAIN_PARITY_LR``, clip 1.0) from ``state``:
    ([loss, grad norm] per step, the final parameters)."""
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import build_train_step

    step = build_train_step(model, adamw(TRAIN_PARITY_LR), clip_norm=1.0)
    metrics = []
    for batch in batches:
        state, met = step(state, batch)
        metrics.append([float(met["loss"]), float(met["grad_norm"])])
    return metrics, state.params


def gate_batches(cfg, n: int = 3) -> list:
    """Phase 15's f32 gates' batches: ``n`` of 8 rows of 64 tokens."""
    rng = np.random.default_rng(3)
    return [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 64))
                                 ).to("cuda")
             for k in ("tokens", "targets")} for _ in range(n)]


def gate_verdict(want: list, wp, got: list, gp) -> tuple:
    """(max relative difference of the losses and grad norms, parameter
    elements beyond 1e-5 of their leaf's largest magnitude, their count
    allowed, the largest difference): ``gp`` may be stored as blocks."""
    pairs = list(zip(_whole_leaves(gp), _whole_leaves(wp)))
    diffs = [(a - b_).abs() for a, b_ in pairs]
    n = sum(d.numel() for d in diffs)
    flipped = sum(int((d > 1e-5 * float(w.abs().max())).sum())
                  for d, (_, w) in zip(diffs, pairs))
    worst = max(float(d.max()) for d in diffs)
    rel = float(np.max(np.abs(np.array(got) - np.array(want))
                       / np.abs(np.array(want))))
    return rel, flipped, n // 1000, worst


def dist_gate() -> None:
    """Phase 15 (a), the hard gate, f32 at ``reduced(granite-8b,
    d_model=128)`` (4 heads over 1 kv head, hd 32): three AdamW steps over
    the 2 x 2 mesh, the state stored as its blocks, against the
    single-device step, both on the card, with
    ``tests/test_torch_train.py``'s tolerances (losses and grad norms 1e-5
    relative; parameters within 1e-5 of each leaf's largest magnitude but
    for 0.1% of the elements, those within 2 lr); ``ring_allreduce`` exact
    and ``psum_quantized`` within ``max|x|/127 · n`` over the four
    positions; ``ElasticController`` from 4 positions to 2, the values
    kept and the shrunk mesh's loss finite (and the single device's within
    1e-5); then the MoE block with ``dp_axes`` at qwen3-moe's full width
    (:func:`moe_dp_gate`)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.distributed.collectives import (
        psum_quantized, ring_allreduce)
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime.elastic import ElasticController
    from repro_torch.runtime.train_loop import init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config("granite-8b"), d_model=128),
                              dtype="float32")
    plan = card_plan(4, DIST_SHAPE[1])
    one = Model(cfg)
    mesh_model = Model(cfg, plan=plan)
    state = init_train_state(one, adamw(TRAIN_PARITY_LR),
                             torch.Generator(device="cuda").manual_seed(0))
    batches = gate_batches(cfg)
    zero_launches()
    want, wp = dist_steps(one, state, batches)
    # the same weights, stored as the mesh's blocks
    got, gp = dist_steps(mesh_model, init_train_state(
        mesh_model, adamw(TRAIN_PARITY_LR),
        torch.Generator(device="cuda").manual_seed(0)), batches)
    launches = launch_counts()
    rel, flipped, allowed, worst = gate_verdict(want, wp, got, gp)
    log(f"{cfg.name} reduced (d 128, 4 heads over 1 kv head) f32, 3 AdamW "
        f"steps over the {plan.mesh.shape} mesh on cuda:0 (stored as "
        f"blocks) vs one device: losses and grad norms {got} vs {want}, "
        f"max rel {rel:.3g} (tol 1e-5); params {flipped} elements beyond "
        f"1e-5 of their leaf's largest magnitude (tol {allowed}), max "
        f"|diff| {worst:.3g} (tol {2 * TRAIN_PARITY_LR:.3g}); K2 launches "
        f"{launches['flash_attention']}")
    if (rel > 1e-5 or flipped > allowed or worst > 2 * TRAIN_PARITY_LR
            or not launches["flash_attention"]):
        fail("phase 15 (a): the step over the mesh differs from one "
             "device's")

    gen = torch.Generator(device="cuda").manual_seed(5)
    parts = [torch.randint(-1000, 1000, (1001, 64), generator=gen,
                           device="cuda").float() for _ in range(4)]
    exact = parts[0] + parts[1] + parts[2] + parts[3]
    ring = ring_allreduce(parts)
    quant = psum_quantized([p / 7 for p in parts])
    bound = max(float((p / 7).abs().max()) for p in parts) / 127 * 4
    qerr = max(float((q - exact / 7).abs().max()) for q in quant)
    ring_ok = all(torch.equal(r, exact) for r in ring)
    log(f"ring_allreduce over 4 positions on cuda:0 ([1001, 64] f32, the "
        f"lead padded to 1004): exact={ring_ok}; psum_quantized max error "
        f"{qerr:.4g} (bound max|x|/127 * 4 = {bound:.4g})")
    if not ring_ok or qerr > bound + 1e-5:
        fail("phase 15 (a): a training collective is wrong")

    params = state.params
    ctl = ElasticController(cfg, prefer_model=DIST_SHAPE[1])
    p4, plan4 = ctl.remesh(params, ["cuda:0"] * 4)
    p2, plan2 = ctl.remesh(p4, ["cuda:0"] * 2)
    kept = all(torch.equal(a, b_) for a, b_ in zip(_leaves(params),
                                                    _whole_leaves(p2)))
    loss2 = float(Model(cfg, plan=plan2).loss(p2, batches[0])[0])
    loss1 = float(one.loss(params, batches[0])[0])
    log(f"ElasticController events {ctl.events}: values kept={kept}, loss "
        f"on the {plan2.mesh.shape} mesh {loss2:.6f} (one device "
        f"{loss1:.6f})")
    if (not kept or not np.isfinite(loss2)
            or abs(loss2 - loss1) > 1e-5 * abs(loss1)):
        fail("phase 15 (a): the elastic remesh lost values or the loss")
    del state, params, p4, p2
    moe_dp_gate()
    torch.cuda.empty_cache()


#: phase 15 (d)'s meshes of cuda:0: (positions, model positions)
SSM_MESH_PLANS = ((2, 2), (4, 2))


def ssm_gate_config(name: str):
    """Phase 15 (d)'s f32 config: ``reduced(name, d_model=256)`` at the SSD
    scan kernel's widths (P 64; N 128 for mamba2, 64 for zamba2): 8 SSD
    heads, 4 a model position; zamba2 at 3 layers (one remat'd group of
    two Mamba2 layers and the shared block, 4 heads over 4 kv heads at hd
    64, then a tail layer)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced

    full = get_config(name)
    kw = dict(dtype="float32", ssm_head_dim=64, ssm_state=full.ssm_state)
    if full.family == "hybrid":
        kw["num_layers"] = 3
    return dataclasses.replace(reduced(full, d_model=256), **kw)


def ssm_mesh_gate() -> dict:
    """Phase 15 (d), a hard gate: reduced mamba2 and zamba2
    (:func:`ssm_gate_config`) take three f32 AdamW steps over (data 1,
    model 2) and (data 2, model 2) of cuda:0, stored as blocks, against the
    single device on the card at phase 15 (a)'s tolerances; K4's and K2's
    launches equal the wrappers' calls.  Returns each config's launches
    over its mesh runs."""
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import init_train_state

    out = {}
    for name in ("mamba2-2.7b", "zamba2-7b"):
        cfg = ssm_gate_config(name)
        batches = gate_batches(cfg)
        one = Model(cfg)
        want, wp = dist_steps(one, init_train_state(
            one, adamw(TRAIN_PARITY_LR),
            torch.Generator(device="cuda").manual_seed(0)), batches)
        zero_launches()
        with counted_train_calls() as calls:
            for n, model_axis in SSM_MESH_PLANS:
                plan = card_plan(n, model_axis)
                mesh_model = Model(cfg, plan=plan)
                got, gp = dist_steps(mesh_model, init_train_state(
                    mesh_model, adamw(TRAIN_PARITY_LR),
                    torch.Generator(device="cuda").manual_seed(0)), batches)
                rel, flipped, allowed, worst = gate_verdict(want, wp, got,
                                                            gp)
                log(f"{name} reduced (d 256, H {cfg.ssm_heads}, N "
                    f"{cfg.ssm_state}, P 64) f32, 3 AdamW steps over the "
                    f"{plan.mesh.shape} mesh on cuda:0 (stored as blocks) "
                    f"vs one device: losses and grad norms {got} vs {want}, "
                    f"max rel {rel:.3g} (tol 1e-5); params {flipped} "
                    f"elements beyond 1e-5 of their leaf's largest "
                    f"magnitude (tol {allowed}), max |diff| {worst:.3g} (tol "
                    f"{2 * TRAIN_PARITY_LR:.3g})")
                if (rel > 1e-5 or flipped > allowed
                        or worst > 2 * TRAIN_PARITY_LR):
                    fail(f"phase 15 (d): {name}'s steps over the model axis "
                         "differ from one device's")
        launches = launch_counts()
        log(f"{name}: K4/K2 launches {launches} for calls {calls}")
        if (launches["ssd_scan"] != calls["ssd_scan"] or not calls["ssd_scan"]
                or launches["flash_attention"] != calls["flash_attention"]
                or (cfg.family == "hybrid") != bool(
                    calls["flash_attention"])):
            fail(f"phase 15 (d): {name}'s K4/K2 launches {launches} are not "
                 f"its calls {calls}")
        out[name] = {k: launches[k] for k in ("ssd_scan", "flash_attention")}
    return out


def moe_dp_gate(seed: int = 0) -> None:
    """The MoE block with ``dp_axes`` at qwen3-moe-235b-a22b's full width
    (one layer's experts, bf16, capacity factor 8: no drops) over the 2 x 2
    mesh on cuda:0, on one input (4 rows of 256 tokens) against one device
    on the whole input: expert ids identical (each data position's two
    model positions route its rows as one device does), ``y`` within
    ``TOL``, ``aux`` the mean of the per-data-position values."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                              moe_capacity_factor=8.0)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = moe.init_moe(cfg, gen, torch.bfloat16)
    x = torch.randn(4, 256, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)
    plan = card_plan(4, DIST_SHAPE[1])
    with routed_experts() as one_ids:
        one, _ = moe.moe_block(cfg, p, x)
    halves = [float(moe.moe_block(cfg, p, x[i:i + 2])[1]) for i in (0, 2)]
    with routed_experts() as dp_ids:
        y, aux = moe.moe_block(cfg, p, x, mesh=plan.mesh,
                               dp_axes=plan.dp_axes, tp_axis=plan.tp_axis)
    rows = x.shape[1] * 2
    want_ids = [one_ids[0][:rows]] * 2 + [one_ids[0][rows:]] * 2
    c = compare(y, one)
    want_aux = sum(halves) / 2
    log(f"{cfg.name} MoE block (E {cfg.num_experts}, top "
        f"{cfg.experts_per_token}, d {cfg.d_model}, bf16) with dp_axes over "
        f"the {plan.mesh.shape} mesh vs one device: expert ids identical="
        f"{dp_ids == want_ids} ({len(dp_ids)} routing calls of {rows} rows), "
        f"y {tol_text(c, torch.bfloat16)}, aux {float(aux):.6f} vs the mean "
        f"of the data positions' {want_aux:.6f}")
    if (dp_ids != want_ids or not c["ok"]
            or abs(float(aux) - want_aux) > 1e-6 * abs(want_aux)):
        fail("phase 15 (a): the MoE block with dp_axes differs from one "
             "device's")
    del p, x, y, one


def phase_dist(train: dict, seed: int = 0) -> dict:
    """Phase 15: training over a (data 2, model 2) mesh of cuda:0 named four
    times (one host process drives every position; the script needs one
    card), the state stored as the mesh's blocks: (a) :func:`dist_gate`;
    (b) qwen2-1.5b at full width and depth in bf16 at phase 13's b 4 x s
    2048 through :func:`trainer_run` (each data position 2 rows, each
    model position 6 heads over 1 kv head), its first step's loss and
    grad norm against phase 13's on the same weights and batch; (c) the
    training CLI with ``--distributed`` (one card: it trains
    single-device), a subprocess started once (b)'s profiled step has
    finished on the card; (d) :func:`ssm_mesh_gate`; (e) mamba2-2.7b at
    full width and depth in bf16 at phase 13's b 2 x s 2048 over the mesh
    (each model position 40 SSD heads), as (b); (f) (b)'s state as stored
    blocks (:func:`stored_report`): bytes per device, their sum against
    the whole tree's, no tensor larger than its block."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    card = card_line()
    log(f"== phase 15: training over a (data 2, model 2) mesh of cuda:0 "
        f"({card})")
    t0 = time.perf_counter()
    dist_gate()
    t1 = time.perf_counter()
    plan = card_plan(4, DIST_SHAPE[1])
    out = {}
    cli = []
    for i, (name, b, s) in enumerate(TRAIN_CONFIGS):
        cfg = get_config(name)
        # (c) starts once (b)'s last step has finished on the card: it
        # runs beside the host's processing of (b)'s profiled trace, and
        # no timed step shares the card with it
        when_done = (lambda: cli.append(train_cli_start(True))) if i == 0 \
            else None
        # (e)'s step issues ~4x phase 13's host ops: its profile records
        # the card's activity only (a trace of its host ops took the host
        # ~230 s to process)
        try:
            res = trainer_run(f"{name} over {plan.mesh.shape}",
                              Model(cfg, plan=plan), b, s, seed,
                              when_done=when_done, profile_cpu=i == 0)
        except BaseException:
            # a failed run leaves no CLI behind
            if cli:
                cli[0][0].kill()
            raise
        one = train[name]
        part = "(b)" if i == 0 else "(e)"
        d_loss = abs(res["first"]["loss"] / one["first"]["loss"] - 1)
        d_norm = abs(res["first"]["grad_norm"] / one["first"]["grad_norm"]
                     - 1)
        log(f"phase 15 {part}: {name} over the mesh vs phase 13 (one device, "
            f"same weights and batch): first loss {res['first']['loss']:.6f}"
            f" vs {one['first']['loss']:.6f} (rel {d_loss:.3g}, gate "
            f"{DIST_BF16_LOSS_REL:.3g}), grad norm "
            f"{res['first']['grad_norm']:.6f} vs "
            f"{one['first']['grad_norm']:.6f} (rel {d_norm:.3g}, gate "
            f"{DIST_BF16_GNORM_REL:.3g}); step p50 {res['step_ms_p50']} ms vs "
            f"{one['step_ms_p50']} ms, {res['tokens_per_s']} vs "
            f"{one['tokens_per_s']} tokens/s, model-FLOP share "
            f"{res['model_flop_share']} vs {one['model_flop_share']}; init "
            f"peak {res['init_peak_gb']} GB (one device "
            f"{one['init_peak_gb']}), step peak {res['step_peak_gb']} GB (one "
            f"device {one['step_peak_gb']}); one profiled step busy "
            f"{res['profile'].get('device_busy_ms')} ms, share "
            f"{res['profile'].get('device_busy_share')} of the p50; launches "
            f"{res['launches']} ({card})")
        if d_loss > DIST_BF16_LOSS_REL or d_norm > DIST_BF16_GNORM_REL:
            fail(f"phase 15 {part}: the first step over the mesh is not one "
                 "device's within bf16 tolerance")
        out[name] = res
        if i == 0:
            t2 = time.perf_counter()
            out["cli"] = train_cli_finish(cli[0])
            t3 = time.perf_counter()
            out["ssm_gate"] = ssm_mesh_gate()
            t4 = time.perf_counter()
    st = out[TRAIN_CONFIGS[0][0]]["stored"]
    log(f"phase 15 (f): {TRAIN_CONFIGS[0][0]}'s parameters and moments "
        f"stored as blocks ({st['blocked_leaves']} of {st['leaves']} leaves "
        f"split): bytes per device {st['bytes_per_device']}, whole tree "
        f"{st['whole_bytes']} bytes, sum equal={st['sum_equal']}, tensors "
        f"larger than their block {st['larger_than_block']}; step peak "
        f"{out[TRAIN_CONFIGS[0][0]]['step_peak_gb']} GB (phase 13, one "
        f"device: {train[TRAIN_CONFIGS[0][0]]['step_peak_gb']} GB)")
    if not st["sum_equal"] or st["larger_than_block"] or not st[
            "blocked_leaves"]:
        fail("phase 15 (f): the stored blocks do not tile the state")
    secs = {"a": t1 - t0, "b": t2 - t1, "c_after_b": t3 - t2,
            "d": t4 - t3, "e": time.perf_counter() - t4}
    log("phase 15 parts (s): " + json.dumps(
        {k: round(v, 1) for k, v in secs.items()}))
    return out


def dist_timing(gen, timer, dist: dict) -> dict:
    """Phase 10's row at phase 15's per-position training shape, bf16: K2
    at qwen2-1.5b's b 2 x s 2048 over one model position's heads (h 6 over
    kv 1, hd 128; chunk 1024), held against its plain version first: the
    kernel forward beside the plain forward and the plain recompute
    backward, SDPA's forward (the library call) and forward + backward.
    Launches: phase 15 (b)'s."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.layers import chunked_attention_vjp

    bf16 = torch.bfloat16
    name, b, s = TRAIN_CONFIGS[0]
    b //= DIST_SHAPE[0]
    q, k, v, g = (torch.randn(b, s, n, 128, generator=gen,
                              device="cuda").to(bf16) for n in (6, 1, 1, 6))
    c = compare(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    if not c["ok"]:
        fail(f"K2 at phase 15's position shape: {tol_text(c, bf16)}")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gt = g.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), gt)
    bnd, by = bound_ms(*flash_cost(q, k), bf16)
    ms = timer(lambda: flash_attention(q, k, v))
    plain = timer(lambda: flash_attention_ref(q, k, v), 5)
    plain_bwd = timer(lambda: chunked_attention_vjp(q, k, v, g, chunk=1024),
                      5)
    with torch.no_grad():
        lib = timer(sdpa)
    lib_fb = timer(sdpa_fwd_bwd)
    launches = dist[name]["launches"]["flash_attention"]
    log(f"K2 training position b={b} s={s} h=6 kv=1: {tol_text(c, bf16)}; "
        f"kernel forward {ms:.4f} ms, plain forward {plain:.4f} ms, plain "
        f"recompute backward {plain_bwd:.4f} ms, sdpa forward {lib:.4f} ms, "
        f"sdpa forward + backward {lib_fb:.4f} ms, bound {bnd:.4f} ms "
        f"({by}), {launches} launches in phase 15")
    return {
        "name": f"flash_attention (training position: {name}, b {b}, h 6, "
                "kv 1)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
        "launches": launches, "max_abs_err": c["max_abs_err"], "ms": ms,
        "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": lib}


def shard_timing(gen, timer, dist: dict) -> list:
    """Phase 10's rows at phase 15's per-model-position training shapes,
    bf16, one data position's b 1 × s 2048 at model 2: K4 at mamba2-2.7b's
    (H 40, N 128, P 64; launches phase 15 (e)'s) and zamba2-7b's (H 56, N
    64, P 64), and K2 at zamba2-7b's shared block (h 16 over kv 16, hd
    112; chunk 1024) with SDPA's forward beside it, each held against its
    plain version first (zamba2's launches: phase 15 (d)'s, the same
    shard-local passes at the gate's widths)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    bf16, s = torch.bfloat16, 2048
    rows = []
    for name, H, N, launches in (
            ("mamba2-2.7b", 40, 128, dist["mamba2-2.7b"]["launches"][
                "ssd_scan"]),
            ("zamba2-7b", 56, 64, dist["ssm_gate"]["zamba2-7b"]["ssd_scan"])):
        args = ssd_case(gen, s=s, H=H, N=N, b=1)
        y_ref, st_ref = ssd_scan_ref(*args)
        y, st = ssd_scan(*args)
        cy, cs = compare(y, y_ref), compare(st, st_ref)
        if not (cy["ok"] and cs["ok"]):
            fail(f"K4 at {name}'s model position: y {tol_text(cy, bf16)}; "
                 f"state {tol_text(cs, torch.float32)}")
        bnd, by = bound_ms(*ssd_cost(args[0], args[3]), bf16)
        ms = timer(lambda: ssd_scan(*args))
        plain = timer(lambda: ssd_scan_ref(*args), 5)
        log(f"K4 training model position ({name}, b 1, s {s}, H {H}, N {N}, "
            f"P 64): {tol_text(cy, bf16)}; kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}), {launches} launches "
            "in phase 15")
        rows.append({
            "name": f"ssd_scan (training model position: {name}, b 1, H {H},"
                    f" N {N})",
            "route": "cuda",
            "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:92",
            "launches": launches,
            "max_abs_err": max(cy["max_abs_err"], cs["max_abs_err"]),
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None})
        del args, y_ref, st_ref, y, st
    q, k, v = (torch.randn(1, s, 16, 112, generator=gen, device="cuda").to(
        bf16) for _ in range(3))
    c = compare(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    if not c["ok"]:
        fail(f"K2 at zamba2's shared-block shard: {tol_text(c, bf16)}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bnd, by = bound_ms(*flash_cost(q, k), bf16)
    ms = timer(lambda: flash_attention(q, k, v))
    plain = timer(lambda: flash_attention_ref(q, k, v), 5)
    lib = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True))
    launches = dist["ssm_gate"]["zamba2-7b"]["flash_attention"]
    log(f"K2 training model position (zamba2-7b's shared block, b 1, s {s}, "
        f"h 16 over kv 16, hd 112): {tol_text(c, bf16)}; kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}),"
        f" {launches} launches in phase 15")
    rows.append({
        "name": "flash_attention (training model position: zamba2-7b's "
                "shared block, b 1, h 16, kv 16, hd 112)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
        "launches": launches, "max_abs_err": c["max_abs_err"], "ms": ms,
        "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": lib})
    return rows


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


def phase_timing(gen, main: dict, legacy: dict, ssm: dict,
                 explore: dict, door: dict, families: dict,
                 train: dict, tp: dict, dist: dict, ex: dict,
                 plan: dict) -> list:
    """Kernel rows: K1 and K2 at the fused dense path's shapes, K3 at path
    B's, K4 at path A's; K1's and K2's launches are the fused dense
    path's, the public API phase's, the front door's and phases 11 and
    12's (K3's path B's and phases 11 and 12's, K4's path A's and
    zamba2-7b's).  Then the families' rows: K1/K3 at stablelm-12b's decode
    (hd 160), K2 at hd 160 and hd 112 with SDPA beside it, K1 at
    nemotron-4-15b's g 6 and qwen3-moe-235b-a22b's g 16."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_chunk_attention)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_chunk_attention_ref)
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    log("== phase 10: kernel times at the main paths' shapes "
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
        old = CUDA_CORE_MS["paged_chunk_attention", name]
        log(f"K1 {name} b={shp['b']} t={shp['t']} splits={splits}: "
            f"kernel {ms:.4f} ms (CUDA-core walk {old:.4f} ms, "
            f"{old / ms:.1f}x), plain {plain:.4f} ms, bound {bnd:.4f} ms "
            f"({by})")
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
        "launches": main["launches"]["paged_chunk_attention"]
        + explore["launches"]["paged_chunk_attention"]
        + door["launches"]["paged_chunk_attention"]
        + family_launches(families, "paged_chunk_attention")
        + phase16_launches(ex, "paged_chunk_attention"),
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
        old = CUDA_CORE_MS["flash_attention", s]
        log(f"K2 s={s}: kernel {ms:.4f} ms (CUDA-core design {old:.4f} ms, "
            f"{old / ms:.1f}x), sdpa {lib:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bnd:.4f} ms ({by})")
    f = k2[1023]
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
        "launches": main["launches"]["flash_attention"]
        + explore["launches"]["flash_attention"]
        + door["launches"]["flash_attention"]
        + family_launches(families, "flash_attention")
        + train["qwen2-1.5b"]["launches"]["flash_attention"]
        + dist["qwen2-1.5b"]["launches"]["flash_attention"]
        + phase16_launches(ex, "flash_attention")
        + plan["qwen2-1.5b"]["launches"]["flash_attention"],
        "max_abs_err": f["max_abs_err"], "ms": f["ms"],
        "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
        "bound_by": f["bound_by"], "library_ms": f["library_ms"],
    })
    k3 = {}
    for name, lengths in (("decode", legacy["decode_lengths"]),
                          ("decode_len1024", [1024] * 32)):
        case = cached_case(paged_case(gen, b=32, t=1, kv=2, g=6, hd=128,
                                      page=16, lengths=lengths,
                                      dtype=torch.bfloat16))
        c = compare(paged_attention(**case), paged_attention_ref(**case))
        log(f"K3 {name}: {tol_text(c, torch.bfloat16)}")
        if not c["ok"]:
            fail(f"paged_attention disagrees with its plain version at path "
                 f"B's {name} shape")
        ms = timer(lambda: paged_attention(**case))
        plain = timer(lambda: paged_attention_ref(**case), 5)
        bnd, by = bound_ms(*cached_cost(case), torch.bfloat16)
        k3[name] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                        max_abs_err=c["max_abs_err"])
        old = CUDA_CORE_MS["paged_attention", name]
        log(f"K3 {name} b=32 (lengths {min(lengths)}-{max(lengths)}): "
            f"kernel {ms:.4f} ms (CUDA-core walk {old:.4f} ms, "
            f"{old / ms:.1f}x), plain {plain:.4f} ms, bound {bnd:.4f} ms "
            f"({by})")
    d = k3["decode"]
    rows.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_chunk_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:114",
        "launches": legacy["launches"]["paged_attention"]
        + family_launches(families, "paged_attention"),
        "max_abs_err": d["max_abs_err"], "ms": d["ms"],
        "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": None,
    })
    k4 = {}
    for s in ssm["prefill_lengths"]:
        args = ssd_case(gen, s=s)
        y_ref, state_ref = ssd_scan_ref(*args)
        y, state = ssd_scan(*args)
        cy, cs = compare(y, y_ref), compare(state, state_ref)
        log(f"K4 s={s}: y {tol_text(cy, torch.bfloat16)}; state "
            f"{tol_text(cs, torch.float32)}")
        if not (cy["ok"] and cs["ok"]):
            fail(f"ssd_scan disagrees with its plain version at path A's "
                 f"s={s}")
        ms = timer(lambda: ssd_scan(*args))
        plain = timer(lambda: ssd_scan_ref(*args), 5)
        bnd, by = bound_ms(*ssd_cost(args[0], args[3]), torch.bfloat16)
        k4[s] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                     max_abs_err=max(cy["max_abs_err"], cs["max_abs_err"]))
        old = CUDA_CORE_MS["ssd_scan", s]
        log(f"K4 s={s} H=80 P=64 N=128 bf16: kernel {ms:.4f} ms (CUDA-core "
            f"design {old:.4f} ms, {old / ms:.1f}x), plain {plain:.4f} ms, "
            f"bound {bnd:.4f} ms ({by})")
        del args, y_ref, state_ref, y, state
    d = k4[max(k4)]
    rows.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:92",
        "launches": ssm["launches"]["ssd_scan"]
        + family_launches(families, "ssd_scan")
        + train["mamba2-2.7b"]["launches"]["ssd_scan"]
        + dist["mamba2-2.7b"]["launches"]["ssd_scan"]
        + phase16_launches(ex, "ssd_scan")
        + plan["mamba2-2.7b"]["launches"]["ssd_scan"],
        "max_abs_err": d["max_abs_err"], "ms": d["ms"],
        "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": None,
    })
    family_timing(gen, timer, families)
    train_timing(gen, timer, train)
    rows += tp_timing(gen, timer, tp)
    rows.append(dist_timing(gen, timer, dist))
    rows += shard_timing(gen, timer, dist)
    return rows


def family_launches(families: dict, name: str) -> int:
    """One kernel's launches over phase 11's and phase 12's runs."""
    return sum(res[key]["launches"][name] for res in families.values()
               for key in ("fused", "ref", "image", "audio", "hybrid")
               if key in res)


def family_timing(gen, timer, families: dict) -> None:
    """Phase 10's rows at phase 11's and 12's shapes (bf16, page 16): K1
    at stablelm-12b's fused decode (b=16, kv 8, g 4, hd 160, the step's
    lengths), at nemotron-4-15b's (g 6, hd 128) and at
    qwen3-moe-235b-a22b's (kv 4, g 16), K3 at stablelm's path B decode, K2
    at hd 160 (h 32, kv 8, s 1023) and at zamba2-7b's hd 112 (h 32 = kv,
    s 1023) beside SDPA.  Each kernel is held against its plain version
    first."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_chunk_attention)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_chunk_attention_ref)

    bf16 = torch.bfloat16
    out = {}
    for label, name, kv, g, hd, path in (
            ("K1 stablelm-12b decode", "stablelm-12b", 8, 4, 160, "fused"),
            ("K1 nemotron-4-15b decode", "nemotron-4-15b", 8, 6, 128,
             "fused"),
            ("K3 stablelm-12b decode", "stablelm-12b", 8, 4, 160, "ref"),
            ("K1 qwen3-moe-235b-a22b decode", "qwen3-moe-235b-a22b", 4, 16,
             128, "fused")):
        res = families[name][path]
        lengths = res["decode_lengths"]
        case = paged_case(gen, b=len(lengths), t=1, kv=kv, g=g, hd=hd,
                          page=16, lengths=lengths, dtype=bf16)
        if path == "ref":
            case = cached_case(case)
            fn, ref_fn, cost = paged_attention, paged_attention_ref, \
                cached_cost
            kernel = "paged_attention"
        else:
            fn, ref_fn, cost = paged_chunk_attention, \
                paged_chunk_attention_ref, paged_cost
            kernel = "paged_chunk_attention"
        c = compare(fn(**case), ref_fn(**case))
        if not c["ok"]:
            fail(f"{label}: {kernel} disagrees with its plain version "
                 f"({tol_text(c, bf16)})")
        ms = timer(lambda: fn(**case))
        plain = timer(lambda: ref_fn(**case), 5)
        bnd, by = bound_ms(*cost(case), bf16)
        out[label] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                          launches=res["launches"][kernel],
                          max_abs_err=c["max_abs_err"])
        log(f"{label} b={len(lengths)} kv={kv} g={g} hd={hd} (lengths "
            f"{min(lengths)}-{max(lengths)}): kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}), "
            f"{res['launches'][kernel]} launches in {name}'s {path} run")
    for label, name, kv, hd, key in (
            ("K2 hd 160 s=1023", "stablelm-12b", 8, 160, "fused"),
            ("K2 hd 112 s=1023", "zamba2-7b", 32, 112, "hybrid")):
        q, k, v = flash_case(gen, s=1023, h=32, kv=kv, hd=hd)
        c = compare(flash_attention(q, k, v), flash_attention_ref(q, k, v))
        if not c["ok"]:
            fail(f"{label}: flash_attention disagrees with its plain "
                 f"version ({tol_text(c, bf16)})")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = timer(lambda: flash_attention(q, k, v))
        plain = timer(lambda: flash_attention_ref(q, k, v), 5)
        lib = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bnd, by = bound_ms(*flash_cost(q, k), bf16)
        launches = families[name][key]["launches"]["flash_attention"]
        out[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=bnd, bound_by=by, launches=launches,
                          max_abs_err=c["max_abs_err"])
        log(f"K2 h=32 kv={kv} hd={hd} s=1023: kernel {ms:.4f} ms, sdpa "
            f"{lib:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}), "
            f"{launches} launches in {name}'s {key} run")
    log("family kernel rows: " + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 16: the examples' torch twins and profile_cell on the card
# ---------------------------------------------------------------------------

#: (a) the twins run in process: (script, argv, marker lines)
TWINS = (("quickstart_torch", [], ("-ESTALE", "quickstart complete")),
         ("agentic_serve_torch", [], ("committing branch",
                                      "final sequence")),
         ("speculative_train_torch", [], ("speculative training complete",)))
#: train_100m_torch.py at its full 100M config, cut to this many steps
TRAIN_100M_STEPS = 30
#: (b) profile_cell --device cuda's cells: (arch, shape, one-card batch)
PROFILE_CELLS = (("qwen2-1.5b", "decode_32k", 16),
                 ("qwen2-1.5b", "prefill_32k", 1),
                 ("mamba2-2.7b", "prefill_32k", 1))
#: a step faster than the op counter's bound would mean the counter
#: over-counts: the share may pass 1 by the timing noise only
ROOFLINE_SHARE_MAX = 1.05
#: the kernels' function names by wrapper, as the tracer reports them
KERNEL_EVENTS = {"paged_chunk_attention": ("paged_tc_kernel",
                                           "paged_chunk_attention_kernel",
                                           "paged_chunk_combine_kernel"),
                 "flash_attention": ("flash_attention_tc_kernel",
                                     "flash_attention_kernel"),
                 "ssd_scan": ("ssd_scan_tc_kernel", "ssd_scan_kernel")}


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, argv: list, markers=()) -> str:
    """Run an example twin's ``main(argv)`` in process, its output kept
    (and its last lines logged); fail unless every marker line is in it."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        load_example(name).main(argv)
    text = buf.getvalue()
    for line in text.splitlines()[-3:]:
        log(f"  {name}: {line[:150]}")
    for m in markers:
        if m not in text:
            fail(f"phase 16: {name} printed no {m!r} line")
    return text


def traced_kernels(prof) -> dict:
    """Each wrapper's kernels the tracer saw, by wrapper name."""
    out = {name: 0 for name in KERNEL_EVENTS}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, fns in KERNEL_EVENTS.items():
            if any(f in e.name for f in fns):
                out[name] += 1
    return out


def client_run() -> dict:
    """``agentic_serve_torch.py --client`` against ``python -m
    repro_torch.launch.serve --serve 127.0.0.1:0`` on the card."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--serve",
         "127.0.0.1:0"], cwd=ROOT, env=src_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        if not first.startswith("serving on http://"):
            fail(f"phase 16: the front door did not start: {first!r} "
                 f"{proc.stderr.read()[-2000:]}")
        url = first.split()[2]
        text = run_example("agentic_serve_torch", ["--client", url])
        proc.send_signal(signal.SIGINT)
        rest, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0 or text.count("final sequence") != 3:
        fail(f"phase 16: --client run failed (rc {proc.returncode}): "
             f"{text[-1000:]} {err[-2000:]}")
    log(f"  front door: {rest.strip()}")
    return {"seconds": round(time.perf_counter() - t0, 1)}


def phase_examples() -> dict:
    """(a) The four examples' torch twins on the card: quickstart,
    agentic_serve and speculative_train in process inside one profiler
    window that counts their K1 and K2 launches against the wrappers'
    counts; train_100m at its full 100M config for TRAIN_100M_STEPS steps
    (its loss must fall); agentic_serve --client against the port's front
    door as a subprocess.  (b) profile_cell --device cuda on
    PROFILE_CELLS: top kernels, busy share, step ms and the roofline share
    (at most ROOFLINE_SHARE_MAX)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_cell import profile_on_card

    log("== phase 16: the examples' torch twins and profile_cell on the card")
    out: dict = {"parts_s": {}}
    t = time.perf_counter()
    zero_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for name, argv, markers in TWINS:
            run_example(name, argv, markers)
        torch.cuda.synchronize()
    counted = launch_counts()
    traced = traced_kernels(prof)
    out["twins_launches"] = {k: counted[k] for k in (
        "paged_chunk_attention", "flash_attention")}
    out["twins_traced"] = {k: traced[k] for k in (
        "paged_chunk_attention", "flash_attention")}
    log(f"phase 16 (a) twins: launches {out['twins_launches']}, traced "
        f"{out['twins_traced']}")
    for k, n in out["twins_launches"].items():
        if not n:
            fail(f"phase 16: the twins never launched {k}")
        if out["twins_traced"][k] > n:
            fail(f"phase 16: the tracer saw more {k} kernels than launched")
    out["parts_s"]["twins"] = round(time.perf_counter() - t, 1)

    t = time.perf_counter()
    zero_launches()
    with tempfile.TemporaryDirectory() as ckpt:
        # two checkpoints: each run() of the trainer commits one as it
        # returns, and a BranchFS commit of the ~1.2 GB f32 state took ~7 s
        # on the card's host (PERF.md, phase 16), so the twin logs every 15
        # steps where the JAX example's cadence would commit 30 times
        text = run_example("train_100m_torch", [
            "--steps", str(TRAIN_100M_STEPS), "--ckpt-dir", ckpt,
            "--ckpt-every", str(TRAIN_100M_STEPS),
            "--log-every", str(TRAIN_100M_STEPS // 2)], ("->",))
    out["train_100m_launches"] = launch_counts()["flash_attention"]
    out["train_100m_loss"] = next(ln for ln in text.splitlines()
                                  if ln.startswith("loss "))
    if not out["train_100m_launches"]:
        fail("phase 16: train_100m_torch never launched flash_attention")
    out["parts_s"]["train_100m"] = round(time.perf_counter() - t, 1)
    out["client"] = client_run()
    out["parts_s"]["client"] = out["client"]["seconds"]

    t = time.perf_counter()
    out["cells"] = {}
    for arch, shape, batch in PROFILE_CELLS:
        zero_launches()
        res = profile_on_card(arch, shape, batch, top=8)
        res["launches"] = {k: v for k, v in launch_counts().items() if v}
        for name, n, ms in res.pop("top_kernels"):
            log(f"  {arch} {shape}: {ms:9.3f} ms {n:5d}x {name[:80]}")
        log(f"phase 16 (b) {arch} {shape} ({res['reduction']}): step "
            f"{res['step_ms']:.2f} ms, busy {res['busy_share']:.3f} of the "
            f"traced step ({res['busy_of_step']:.3f} of the untraced), "
            f"roofline share {res['roofline_share']:.3f} of its "
            f"{res['bound_by']} bound (compute {res['t_compute_ms']:.2f} "
            f"ms, memory {res['t_memory_ms']:.2f} ms), launches "
            f"{res['launches']}")
        if res["roofline_share"] > ROOFLINE_SHARE_MAX:
            fail(f"phase 16: {arch} {shape} steps faster than its counted "
                 f"bound ({res['roofline_share']:.3f})")
        out["cells"][f"{arch} {shape}"] = res
        gc.collect()
        torch.cuda.empty_cache()
    out["parts_s"]["profile_cell"] = round(time.perf_counter() - t, 1)
    log("phase 16 parts (s): " + json.dumps(out["parts_s"]))
    return out


def phase16_launches(ex: dict, name: str) -> int:
    """One kernel's launches over phase 16's runs (the twins, the 100M
    training, the profiled cells)."""
    n = ex["twins_launches"].get(name, 0)
    if name == "flash_attention":
        n += ex["train_100m_launches"]
    return n + sum(c["launches"].get(name, 0) for c in ex["cells"].values())


# ---------------------------------------------------------------------------
# phase 17: serving over a plan, every mesh position on the card
# ---------------------------------------------------------------------------

#: phase 17's bf16 runs: (config, (data, model) positions of cuda:0, layers
#: kept: None for the full depth), the batch, prompt length and steps
PLAN_RUNS = (("qwen2-1.5b", (2, 2), None), ("mamba2-2.7b", (1, 2), 16))
PLAN_B, PLAN_S, PLAN_STEPS = 4, 512, 16
#: bf16 logits over the mesh against one device: the model positions'
#: partial sums rounded apart, as ``TP_BF16_REL_RMS``
PLAN_BF16_REL_RMS = 2 ** -5
#: f32 over the mesh, card (kernels) against CPU (plain versions)
PLAN_F32_TOL = 1e-4


def plan_run(cfg, params, shape, tokens: torch.Tensor, steps: int,
             device: str = "cuda:0") -> dict:
    """``Model(cfg, plan=)`` over a (data, model) mesh of ``shape`` with
    every position on ``device`` (one device's ``Model`` for ``shape``
    None): the prefill's logits, then ``steps`` greedy ``decode_step``s;
    every logits on the host in f32 and the greedy tokens."""
    from repro_torch.distributed.mesh import DeviceMesh, plan_from_mesh
    from repro_torch.models import Model

    if shape is None:
        model = Model(cfg)
    else:
        devs = np.empty(shape, dtype=object)
        devs[...] = device
        model = Model(cfg, plan=plan_from_mesh(
            DeviceMesh(devs, ("data", "model"))))
    b, s = tokens.shape
    logits, cache = model.prefill(params, tokens, max_len=s + steps)
    out = {"logits": [logits.float().cpu()], "tokens": []}
    for i in range(steps):
        tok = logits[:, -1].argmax(-1)
        out["tokens"].append(tok.tolist())
        pos = torch.full((b,), s + i, device=tokens.device)
        logits, cache = model.decode_step(params, cache, tok[:, None], pos)
        out["logits"].append(logits.float().cpu())
    return out


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).square().mean().sqrt()
            / want.square().mean().sqrt()).item()


def plan_f32_gate() -> None:
    """Phase 17's hard gate in f32: a reduced dense config
    (``reduced(granite-8b, d_model=128)``: 4 heads over 1 kv head, hd 32)
    and a reduced SSM config (:func:`ssm_gate_config`: mamba2 at the scan
    kernel's widths) over (data 2, model 2), cuda:0 (the kernels) against
    the CPU (their plain versions): identical greedy tokens, every logits
    within ``PLAN_F32_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    for cfg in (dataclasses.replace(reduced(get_config("granite-8b"),
                                            d_model=128), dtype="float32"),
                ssm_gate_config("mamba2-2.7b")):
        params = Model(cfg).init(torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (4, 64)))
        runs = {dev: plan_run(cfg, _to(params, dev), (2, 2),
                              tokens.to(dev), 4, device=dev)
                for dev in ("cuda:0", "cpu")}
        card, cpu = runs["cuda:0"], runs["cpu"]
        err = max((a - b).abs().max().item()
                  for a, b in zip(card["logits"], cpu["logits"]))
        same = card["tokens"] == cpu["tokens"]
        log(f"{cfg.name} reduced (d {cfg.d_model}) f32 over (data 2, model "
            f"2): card vs CPU greedy tokens identical={same}, logits max "
            f"|diff| {err:.3g} (tol {PLAN_F32_TOL})")
        if not (same and err <= PLAN_F32_TOL):
            fail(f"phase 17: {cfg.name}'s serving over a plan differs "
                 "between the card and the CPU")


def phase_plan_serve(seed: int = 0) -> dict:
    """Phase 17: serving over a plan (``Model(plan=).prefill`` and
    ``decode_step``) with every mesh position on cuda:0: the f32 gate
    (:func:`plan_f32_gate`), then each of ``PLAN_RUNS`` in bf16 at full
    width (qwen2-1.5b at full depth over (data 2, model 2); mamba2-2.7b cut
    in depth over (data 1, model 2)): b ``PLAN_B`` × s ``PLAN_S``, then
    ``PLAN_STEPS`` greedy steps, against one device's ``Model`` on the card:
    the prefill's logits within ``PLAN_BF16_REL_RMS``, the greedy tokens'
    agreement printed, K2's (K4's) launches equal to its calls."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    log("== phase 17: serving over a plan, every position on cuda:0")
    card = card_line()
    plan_f32_gate()
    out = {}
    for name, shape, layers in PLAN_RUNS:
        cfg = get_config(name)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        params = Model(cfg).init(
            torch.Generator(device="cuda").manual_seed(seed))
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (PLAN_B, PLAN_S))).to("cuda")
        zero_launches()
        with counted_train_calls() as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = plan_run(cfg, params, shape, tokens, PLAN_STEPS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items()
                    if k in ("flash_attention", "ssd_scan")}
        kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
        want = plan_run(cfg, params, None, tokens, PLAN_STEPS)
        rel = rel_rms(got["logits"][0], want["logits"][0])
        agree = float(np.mean(np.array(got["tokens"])
                              == np.array(want["tokens"])))
        finite = all(bool(torch.isfinite(x).all()) for x in got["logits"])
        log(f"{name} ({cfg.num_layers} layers) bf16 over (data {shape[0]}, "
            f"model {shape[1]}) of cuda:0, b {PLAN_B} x s {PLAN_S} and "
            f"{PLAN_STEPS} steps in {secs:.1f} s: prefill logits vs one "
            f"device relative RMS {rel:.3g} (gate {PLAN_BF16_REL_RMS:.3g}), "
            f"greedy tokens agree on {agree:.3f}; launches {launches} for "
            f"calls {calls} ({card})")
        if not (rel <= PLAN_BF16_REL_RMS and finite and calls[kernel]
                and all(launches[k] == calls[k] for k in launches)):
            fail(f"phase 17: {name} over the plan: logits {rel:.3g} from one "
                 f"device's (finite={finite}), or launches {launches} not "
                 f"its calls {calls}")
        out[name] = {"layers": cfg.num_layers, "mesh": list(shape),
                     "seconds": round(secs, 1), "prefill_rel_rms": rel,
                     "tokens_agree": agree, "launches": launches}
        del params
        torch.cuda.empty_cache()
    return out


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
        log(f"{name}: ptxas per kernel (registers, spill stores):")
        for kernel, regs, spill in ptxas_report(text):
            log(f"  {regs:3d} registers, {spill:3d} bytes spilled: "
                f"{kernel[:100]}")
    flash_log = _build.BUILD_LOGS.get("flash_attention")
    if flash_log is not None and not any(
            "flash_attention_tc_kernelILi112E" in kernel
            for kernel, _, _ in ptxas_report(flash_log)):
        fail("flash_attention was built without its hd 112 wgmma kernel")
    for name in sorted(_build.SOURCES):
        n = tensor_core_counts(_build.library_path(name))
        log(f"{name}: {n['HGMMA']} HGMMA and {n['HMMA']} HMMA instructions "
            "in its SASS")
        if name in ("flash_attention", "ssd_scan") and not n["HGMMA"]:
            fail(f"{name} was built without tensor-core (wgmma) instructions")
        if name == "paged_chunk_attention" and not (n["HGMMA"] or n["HMMA"]):
            fail(f"{name} was built without tensor-core instructions")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    t0 = time.perf_counter()
    secs = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        secs[name] = round(time.perf_counter() - t, 1)
        log(f"-- {name} took {secs[name]} s")
        return out

    timed("phase 2", phase_kernels, gen)
    dense, legacy = timed("phase 3", phase_dense)
    ssm = timed("phase 4", phase_ssm)
    timed("phase 5", phase_parity)
    explore = timed("phase 6", phase_explore)
    timed("phase 6 cli", phase_cli)
    door = timed("phase 7", phase_front_door)
    device_explore = timed("phase 8", phase_device_explore)
    fs = timed("phase 9", phase_branchfs)
    families = timed("phase 11", phase_families)
    families.update(timed("phase 12", phase_hybrid_moe))
    train = timed("phase 13", phase_train)
    tp = timed("phase 14", phase_tp)
    dist = timed("phase 15", phase_dist, train)
    ex = timed("phase 16", phase_examples)
    plan = timed("phase 17", phase_plan_serve)
    rows = timed("phase 10", phase_timing, gen, dense, legacy, ssm, explore,
                 door, families, train, tp, dist, ex, plan)
    log(f"total {time.perf_counter() - t0:.1f} s after the build; by phase "
        f"{json.dumps(secs)}")
    keys = ("prefill_ms", "decode_step_ms_p50", "decode_tokens_per_s",
            "launches", "profile")
    for name, res in (("dense path (fused)", dense),
                      ("path B (attn_impl='ref')", legacy),
                      ("path A (mamba2-2.7b)", ssm)):
        log(f"{name}: " + json.dumps({k: res[k] for k in keys}))
    log("public API phase: " + json.dumps(
        {k: explore[k] for k in ("tokens_per_s", "step_ms_p50",
                                 "decode_ms_p50", "host_ms_p50",
                                 "control_ms_p50", "launches",
                                 "profile")}))
    log("front door phase: " + json.dumps(door))
    log("device explore: " + json.dumps(device_explore))
    log(f"BranchFS ({os.uname().nodename}): " + json.dumps(fs))
    log("training phase (13): " + json.dumps(train))
    log("training over a mesh (15, data 2 x model 2 on one card): "
        + json.dumps(dist))
    log("examples and profiled cells (16): " + json.dumps(ex))
    log("serving over a plan (17, every position on cuda:0): "
        + json.dumps(plan))
    log("tensor-parallel phase (14, tp 2 on one card): " + json.dumps(
        {name: {path: {k: r[k] for k in (
            "prefill_ms", "decode_step_ms_p50", "decode_tokens_per_s",
            "device_busy_share", "launches", "first_step_rel_rms",
            "first_step_argmax_agree") if k in r} | {
            "walk_launches_per_step": r["profile"].get(
                "walk_launches_per_step")}
            for path, r in res.items()} for name, res in tp.items()}))
    log("families phases (11, 12): " + json.dumps(
        {name: {k: ({kk: r[kk] for kk in ("prefill_ms", "decode_step_ms_p50",
                                           "decode_tokens_per_s",
                                           "device_busy_share", "launches")
                     if kk in r} if isinstance(r, dict) else r)
                for k, r in res.items()}
         for name, res in families.items()}))
    print(json.dumps({"kernels": rows}))
    print(card)
    # every phase ran on device 0: the run used one card
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))


if __name__ == "__main__":
    main()
