"""Agentic exploration over generations, the PyTorch port: the twin of
``examples/agentic_serve.py`` through ``repro_torch.api``.

Two Tree-of-Thoughts searches (``beam_search``: fork N continuation
branches per level, decode, score, commit the best) plus a nested
``tree_search`` run concurrently on one engine: every request enters
through a :class:`~repro_torch.api.BranchSession` (worst-case page
reservations, every fork a vectorized ``branch()`` with one fused CoW
dispatch), and the exploration driver multiplexes all policies' decode
work into the same continuous batch.  On the card the engine's decode,
verify and suffix prefill run the paged attention kernel and its prefill
the flash attention kernel.

Run:  PYTHONPATH=src python examples/agentic_serve_torch.py [--device cpu]

``--trace trace.json`` records per-branch lifecycle spans, prints the
metrics summary and writes a Chrome/Perfetto timeline.

``--client http://host:port`` drives the same workload over HTTP against
a running front door of the port (``python -m repro_torch.launch.serve
--serve host:port``) instead of building an in-process engine.
"""

import argparse
import dataclasses

import torch

from repro_torch.api import BranchSession
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.explore_ctx import ExplorationDriver, beam_search, tree_search
from repro_torch.models import Model
from repro_torch.obs import Observability
from repro_torch.runtime import ServeEngine


def run_client(url: str) -> None:
    """The same three concurrent searches, over the HTTP front door."""
    import asyncio

    from repro_torch.server import ServeClient

    client = ServeClient(url)

    async def drive() -> None:
        health = await client.health()
        print(f"server: {health}")
        beam, beam2, tree = await asyncio.gather(
            client.explore([7, 3, 9, 21, 14, 2], policy="beam",
                           max_new_tokens=13,
                           params={"width": 3, "depth": 3,
                                   "tokens_per_level": 4,
                                   "temperature": 2.0}),
            client.explore([4, 8, 15, 16, 23, 42], policy="beam",
                           max_new_tokens=13,
                           params={"width": 3, "depth": 3,
                                   "tokens_per_level": 4,
                                   "temperature": 2.0}),
            client.explore([5, 10, 20], policy="tree", max_new_tokens=17,
                           params={"fan_out": 3, "max_nodes": 9,
                                   "tokens_per_node": 4, "max_depth": 3,
                                   "temperature": 2.0}),
        )
        for name, fin in (("beam", beam), ("beam2", beam2),
                          ("tree", tree)):
            if fin["event"] != "result":
                print(f"{name}: {fin['event']} — {fin}")
                continue
            print(f"{name}: final sequence {fin['tokens']}")
        metrics = await client.metrics()
        served = [ln for ln in metrics.splitlines() if "server." in ln]
        print("server metrics:\n  " + "\n  ".join(served))

    asyncio.run(drive())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace.json on exit and "
                         "print the metrics summary")
    ap.add_argument("--client", default=None, metavar="URL",
                    help="drive a running front door over HTTP instead "
                         "of building an in-process engine")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without one) or cpu "
                         "(the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.client:
        run_client(args.client)
        return

    device = resolve_device(args.device)
    cfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32")
    model = Model(cfg, attn_chunk=8, remat=False)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(model, params, num_pages=512, page_size=8,
                         max_pages_per_seq=32, device=device,
                         obs=Observability(trace=args.trace is not None))
    session = BranchSession(engine, max_batch=8, seed=42)
    driver = ExplorationDriver(session)

    prompt = [7, 3, 9, 21, 14, 2]
    print(f"prompt: {prompt}")
    print(f"pool before: {engine.stats()}")

    # three concurrent explorations, one page pool, one batching loop
    beam = driver.explore(prompt, max_new_tokens=13, policy=beam_search,
                          width=3, depth=3, tokens_per_level=4,
                          temperature=2.0, name="beam")
    beam2 = driver.explore([4, 8, 15, 16, 23, 42], max_new_tokens=13,
                           policy=beam_search, width=3, depth=3,
                           tokens_per_level=4, temperature=2.0,
                           name="beam2")
    tree = driver.explore([5, 10, 20], max_new_tokens=17,
                          policy=tree_search, fan_out=3, max_nodes=9,
                          tokens_per_node=4, max_depth=3,
                          temperature=2.0, name="tree")
    driver.run()

    for level in beam.result.stats["levels"]:
        if level.get("degraded"):
            print(f"  level {level['level']}: page pressure — "
                  "decoded unforked")
            continue
        scores = sorted(level["scores"], reverse=True)
        print(f"  level {level['level']}: scores "
              f"{[f'{s:.1f}' for s in scores]} -> "
              f"committing branch {level['winner_seq']}")
    tree_score = ("degraded" if tree.result.score is None
                  else f"{tree.result.score:.1f}")
    print(f"nested tree: created {tree.result.stats['branches_created']} "
          f"branches, winner depth {tree.result.stats.get('winner_depth')}"
          f", score {tree_score}")
    print(f"final sequence: {beam.result.tokens}")
    print(f"concurrent sequence: {beam2.result.tokens}")
    print(f"pool after (drained): {session.tree()['pool']}")
    if args.trace:
        print("metrics summary:")
        print(session.obs.metrics.format())
        session.trace(args.trace)
        print(f"wrote {args.trace} — open at https://ui.perfetto.dev")


if __name__ == "__main__":
    main()
