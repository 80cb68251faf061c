"""Quickstart, the PyTorch port: the paper's Listing 2 (fork / explore /
commit) in branchx, through ``repro_torch``.

The twin of ``examples/quickstart.py``, four faces of one abstraction:
  1. host pytree state (BranchStore)        — ≈ BranchFS
  2. on-disk workspace (BranchFS)           — ≈ BranchFS daemon
  3. stacked device state (explore())       — ≈ branch() + BR_MEMORY,
     the branches raced under ``torch.func.vmap``
  4. the branch() syscall surface itself    — repro_torch.api.BranchSession
     over a ServeEngine

Sampled numbers differ from the JAX example's: the port draws from
counter-based keys, not JAX's.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.core import (
    BranchStore,
    StaleBranchError,
    explore,
    explore_threads,
)
from repro_torch.core.explore import normal
from repro_torch.device import resolve_device
from repro_torch.fs import BranchFS


def demo_store():
    print("== 1. BranchStore: three candidate fixes, tests pick one ==")
    store = BranchStore({"main.py": "print('broken')", "README": "v1"})

    def make_fix(i):
        def fix(branch_id):
            store.write(branch_id, "main.py", f"print('fix {i}')")
            tests_pass = i == 1  # only fix 1 passes its tests
            return tests_pass

        return fix

    winner, statuses = explore_threads(
        store, BranchStore.ROOT, [make_fix(0), make_fix(1), make_fix(2)])
    print(f"   winner branch: {winner}, statuses: "
          f"{[s.value for s in statuses]}")
    print(f"   base now sees: {store.read(BranchStore.ROOT, 'main.py')}")


def demo_fs():
    print("== 2. BranchFS on disk: nested exploration ==")
    with tempfile.TemporaryDirectory() as td:
        fs = BranchFS(td)
        fs.write("base", "config.yaml", b"lr: 1e-4")
        (strategy,) = fs.create(name="strategy-a")
        v1, v2 = fs.create(parent=strategy, n=2)
        fs.write(v1, "config.yaml", b"lr: 3e-4")
        fs.write(v2, "config.yaml", b"lr: 1e-3")
        fs.commit(v2)               # sub-variant wins -> strategy-a
        try:
            fs.read(v1, "config.yaml")
        except StaleBranchError:
            print("   sibling v1 got -ESTALE (as the paper specifies)")
        fs.commit(strategy)         # strategy-a wins -> base
        print(f"   base config: {fs.read('base', 'config.yaml').decode()}")


def demo_device(device):
    print("== 3. Device-side explore(): 4 branches race under vmap ==")
    origin = {"x": torch.zeros(3, device=device),
              "loss": torch.tensor(1e9, device=device)}

    def step(state, key):
        cand = normal(key, (3,))
        loss = torch.sum(cand ** 2)
        return {"x": cand, "loss": loss}, loss < state["loss"], loss

    res = explore(step, origin, 4,
                  torch.Generator(device=device).manual_seed(0),
                  commit_time_fn=lambda a: a)
    print(f"   committed branch {int(res.winner)} with loss "
          f"{float(res.state['loss']):.4f}")


def demo_api(device):
    print("== 4. branch() over a serving engine: the repro_torch.api "
          "surface ==")
    from repro_torch.api import EV_FINISHED, BranchSession, Waiter
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime import ServeEngine

    cfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32")
    model = Model(cfg, attn_chunk=8, remat=False)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(model, params, num_pages=64, page_size=4,
                         max_pages_per_seq=16, device=device)
    session = BranchSession(engine, seed=0)

    root = session.open([7, 3, 9], max_new_tokens=10)
    kids = session.branch(root, n=3)   # one ledger txn, one fused CoW copy
    # epoll-style: wait until every sibling generated 4 tokens
    Waiter(session).add(kids[0], produced=4).add(kids[1], produced=4) \
                   .add(kids[2], produced=4).wait(require_all=True)
    best = max(kids, key=lambda h: sum(session.tokens(h)[3:]))
    session.commit(best)               # siblings -ESTALE, pages recycled
    losers = [h for h in kids if h != best]
    print(f"   poll ready-set after commit: "
          f"{ {h: session.stat(h)['events'] for h in losers} }")
    session.wait([root], events=EV_FINISHED)
    print(f"   committed continuation: {session.result(root)}")
    session.finish(root)
    pool = session.tree()["pool"]
    print(f"   pool drained: {pool['pages_free']}/{pool['pages_total']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without one) or cpu "
                         "(the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    demo_store()
    demo_fs()
    demo_device(device)
    demo_api(device)
    print("quickstart complete")


if __name__ == "__main__":
    main()
