"""Serving entry point of the port: the ``repro_torch.api`` surface end to end.

The port's copy of ``repro/launch/serve.py``, demo mode.  A stream of
requests goes through the exploration driver over one
:class:`~repro_torch.api.BranchSession`: every prompt runs a concurrent
best-of-N policy (vectorized ``branch()`` through page-budget admission,
decode branches in the shared continuous batch, score, first-commit-wins
commit; graceful unforked degradation under page pressure), then the
session's procfs-style ``tree()`` view is printed::

    python -m repro_torch.launch.serve --arch qwen2-1.5b --branches 4

It runs on the card (``--device`` defaults to ``cuda`` and raises without
one) and serves ``--arch`` at full width in the config's own dtype, with
random weights from the port's seeded init.  ``--device cpu`` does what
the JAX demo does: configs above 1e8 parameters are reduced, float32.
Both use the JAX demo's engine geometry (page 8, 64 pages per sequence).

``--serve host:port`` starts the multi-tenant HTTP/SSE front door
(:mod:`repro_torch.server`) instead of the demo: one engine loop serves
every tenant's ``/v1/generate`` and ``/v1/explore`` traffic until
SIGINT/SIGTERM, then drains gracefully (in-flight decodes finish; parked
reservations are evicted) and exits 0.  Port 0 binds a free port; the
address is printed on the ``serving on http://...`` line.
``--tenants name:max_concurrent:priority,...`` registers tenant classes::

    python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --serve 127.0.0.1:8777 --tenants vip:16:3,batch:32:1

``--tp N`` serves through a tensor-parallel engine of ``N`` shards and
prints the ``serving mesh: tp=N over [...]`` line with the shards'
devices: on the first ``N`` cards by default, every shard on one device
with ``--device cpu`` or ``--device cuda:0``.  The weights are drawn shard
by shard (``Model.init(generator, shards=plan)``), so no device ever holds
the whole tree: ``dbrx-132b`` (263 GB in bf16) serves over four 80 GB
cards, about 67 GB of weights a card, and on the cards the ``init peak
per card`` line follows the mesh line::

    python -m repro_torch.launch.serve --tp 4 --arch dbrx-132b \
        --requests 2 --tokens 4 --branches 2

A config the paged engine does not serve (``musicgen-medium``'s four
codebooks, as the JAX engine fails on them, ``mamba2-2.7b`` or the hybrid
``zamba2-7b``, which the JAX engine refuses too) exits 2 with the engine's
refusal.  The MoE configs (``qwen3-moe-235b-a22b``, ``dbrx-132b``) serve
through the engine like the dense ones; at full depth neither fits one
80 GB card (``dbrx-132b`` fits four at ``--tp 4``; qwen3-moe's 470 GB
does not).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-agentic",
                    help="config name: paper-agentic, qwen2-1.5b, "
                         "granite-8b, nemotron-4-15b, stablelm-12b, "
                         "pixtral-12b (text only), qwen3-moe-235b-a22b, "
                         "dbrx-132b; musicgen-medium, mamba2-2.7b and "
                         "zamba2-7b are refused by the paged engine "
                         "(exit 2)")
    ap.add_argument("--branches", type=int, default=3)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=2.0)
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel width of the serving mesh "
                         "(default: single-device; the shards take the "
                         "first N cards, or all lie on --device when it "
                         "names one)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record per-branch lifecycle spans and write a "
                         "Chrome/Perfetto trace.json here on exit "
                         "(also prints the one-screen metrics summary)")
    ap.add_argument("--serve", default=None, metavar="HOST:PORT",
                    help="run the multi-tenant HTTP/SSE front door "
                         "instead of the demo (SIGINT/SIGTERM drains "
                         "gracefully)")
    ap.add_argument("--tenants", default=None,
                    metavar="NAME:MAX_CONCURRENT:PRIORITY,...",
                    help="tenant classes for --serve (unknown tenants "
                         "get the default class)")
    ap.add_argument("--num-pages", type=int, default=1024,
                    help="KV page-pool size (default 1024)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable cross-request KV prefix sharing "
                         "(on by default: identical prompt prefixes "
                         "share read-only CoW pages, so best-of-N from "
                         "N users costs one prefill)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions at the JAX demo's "
                         "reduced size)")
    args = ap.parse_args(argv)

    from repro_torch.api import BranchSession
    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.distributed.mesh import serving_plan, tp_mesh
    from repro_torch.explore_ctx import ExplorationDriver, best_of_n
    from repro_torch.models import Model
    from repro_torch.models.transformer import check_engine_servable
    from repro_torch.obs import Observability
    from repro_torch.runtime import ServeEngine

    device = resolve_device(args.device)
    if args.tp is not None and args.device is None:
        device = None     # the serving mesh takes the first --tp cards
    cfg = get_config(args.arch)
    try:                 # before any weights are drawn
        check_engine_servable(cfg)
    except NotImplementedError as e:
        print(f"--arch {args.arch}: {e}", file=sys.stderr)
        return 2
    if device is not None and device.type == "cpu":
        if cfg.param_count() > 1e8:  # big archs run reduced on CPU demo
            cfg = reduced(cfg)
        cfg = dataclasses.replace(cfg, dtype="float32")
    model = Model(cfg)
    gen = torch.Generator(device=device or "cuda").manual_seed(0)
    try:
        if args.tp is None:
            params, mesh = model.init(gen), None
        else:
            # a width the config or the cards refuse, before any draw
            ServeEngine._check_tp_divisibility(cfg, args.tp)
            mesh = tp_mesh(args.tp, device)
            # drawn shard by shard: no device holds the whole tree
            params = model.init(gen, shards=serving_plan(mesh))
            device = None
        engine = ServeEngine(model, params, num_pages=args.num_pages,
                             page_size=8, max_pages_per_seq=64, mesh=mesh,
                             prefix_cache=not args.no_prefix_cache,
                             obs=Observability(trace=args.trace is not None),
                             device=device)
    except ValueError as e:
        print(f"--tp {args.tp}: {e}", file=sys.stderr)
        return 2
    session = BranchSession(engine, max_batch=args.max_batch, seed=1)
    if session.tp > 1:
        print(f"serving mesh: tp={session.tp} over "
              f"[{', '.join(map(str, engine.devices))}]")
        if engine.device.type == "cuda":
            print("init peak per card: " + ", ".join(
                f"{d} {torch.cuda.max_memory_allocated(d) / 1e9:.2f} GB"
                for d in dict.fromkeys(engine.devices)))
    if args.serve:
        return _serve_front_door(session, args)
    driver = ExplorationDriver(session)

    prompts = {}
    for r in range(args.requests):
        prompt = [int(t) for t in np.random.default_rng(r).integers(
            1, cfg.vocab_size, size=6)]
        exp = driver.explore(prompt, max_new_tokens=args.tokens + 1,
                             policy=best_of_n, n=args.branches,
                             tokens=args.tokens,
                             temperature=args.temperature,
                             name=f"request-{r}")
        prompts[exp] = prompt
    # an infeasible request fails only its own exploration: report it
    # per-request and serve the rest
    driver.run(raise_errors=False)

    for r, (exp, prompt) in enumerate(prompts.items()):
        if exp.error is not None:
            print(f"request {r}: not served ({exp.error}); skipped")
            continue
        res = exp.result
        scores = [f"{s:.1f}" for s in res.stats.get("scores", [])]
        note = " (degraded: page pressure)" if res.stats.get("degraded") \
            else ""
        print(f"request {r}: prompt {prompt} -> {res.generated} "
              f"(best of {res.stats.get('branches', 0)}, "
              f"scores {scores}){note}")
    print("session tree (procfs view):")
    print(session.format_tree(metrics=args.trace is not None))
    if args.trace:
        session.trace(args.trace)
        print(f"wrote {args.trace} — open at https://ui.perfetto.dev")
    return 0


def _parse_tenants(spec):
    """``name:max_concurrent:priority,...`` → TenantConfig list."""
    from repro_torch.server import TenantConfig

    out = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        name = fields[0]
        max_conc = int(fields[1]) if len(fields) > 1 else 16
        priority = int(fields[2]) if len(fields) > 2 else 1
        out.append(TenantConfig(name, max_concurrent=max_conc,
                                priority=priority))
    return out


def _serve_front_door(session, args) -> int:
    import asyncio
    import signal

    from repro_torch.server import FrontDoor

    host, _, port = args.serve.rpartition(":")
    host = host or "127.0.0.1"
    fd = FrontDoor(session, _parse_tenants(args.tenants))

    async def run() -> None:
        server = await fd.serve(host, int(port))
        addr = server.sockets[0].getsockname()
        print(f"serving on http://{addr[0]}:{addr[1]} "
              f"(tenants: {[t.name for t in fd.tenancy.tenants()]})",
              flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        print("draining...", flush=True)
        stats = await fd.shutdown(drain=True)
        print(f"drained cleanly ({stats['evicted']} parked/stale "
              "evicted)", flush=True)
        if args.trace:
            session.trace(args.trace)
            print(f"wrote {args.trace}", flush=True)

    asyncio.run(run())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
