"""Port parity: the host branch substrate (lifecycle kernel + paged-KV
branch manager) against the JAX package's, op for op.

Both managers run one seeded random sequence of fork / fork_batch /
append / commit / abort / release / truncate / prefix / demote / promote
operations.  After every operation the results (or the error's class
name and errno), every block table and length, the free list, the
refcounts, the prefix cache and ``stats()`` must be identical.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.kvbranch import KVBranchManager as JaxManager
from repro_torch.core import KVBranchManager as PortManager

OPS = ("new", "prefix_new", "fork", "fork_batch", "append", "commit",
       "abort", "release", "truncate", "demote", "promote")


def state(kv, seqs):
    per_seq = {s: (list(kv._tables.get(s, [])), kv._lengths.get(s),
                   kv.is_live(s), kv.is_tiered(s)) for s in seqs}
    return (per_seq, list(kv._free), kv._refcount.tolist(), kv.stats(),
            sorted(kv._prefix_pages.items()))


def drive(manager_cls, seed, n_ops=400):
    rng = np.random.default_rng(seed)
    kv = manager_cls(num_pages=64, page_size=4)
    prompt = [int(x) for x in rng.integers(0, 50, 64)]
    seqs = []
    log = []
    for _ in range(n_ops):
        op = OPS[rng.integers(len(OPS))]
        # mostly live targets; sometimes any id ever issued (error paths)
        live = [s for s in seqs if kv.is_live(s)]
        pool = live if live and rng.random() < 0.85 else seqs
        sid = int(pool[rng.integers(len(pool))]) if pool else -1
        try:
            if op == "new":
                out = kv.new_seq(length=int(rng.integers(0, 14)))
                seqs.append(out)
            elif op == "prefix_new":
                toks = prompt[:int(rng.integers(1, 30))]
                pages, covered = kv.match_prefix(toks)
                out = kv.new_seq(length=len(toks), prefix_pages=pages or None)
                kv.register_prefix(out, toks)
                seqs.append(out)
                out = (out, pages, covered)
            elif op == "fork":
                out = kv.fork(sid, int(rng.integers(1, 4)))
                seqs.extend(out)
            elif op == "fork_batch":
                out, ops = kv.fork_batch(sid, int(rng.integers(1, 4)))
                seqs.extend(out)
                out = (out, [(o.src_page, o.dst_page) for o in ops])
            elif op == "append":
                batch = sorted({int(s) for s in
                                rng.choice(pool, size=min(3, len(pool)))})
                out = [[(sl.page, sl.offset,
                         [(c.src_page, c.dst_page) for c in sl.cow])
                        for sl in slots]
                       for slots in kv.prepare_append_batch(batch, 1)]
            elif op == "commit":
                out = kv.commit(sid)
            elif op == "abort":
                out = kv.abort(sid)
            elif op == "release":
                out = kv.release(sid)
            elif op == "truncate":
                out = kv.truncate(sid, int(rng.integers(0, 10)))
            elif op == "demote":
                out = kv.demote(sid)
            else:
                out = kv.promote(sid)
            log.append((op, out))
        except Exception as e:    # compared by class name and errno
            errno = getattr(e, "errno", None)
            log.append((op, type(e).__name__,
                        None if errno is None else int(errno)))
        log.append(state(kv, seqs))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_sequence_is_identical(seed):
    port, ref = drive(PortManager, seed), drive(JaxManager, seed)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p == r, f"step {i // 2}: port {p!r} != reference {r!r}"
    assert len(port) == len(ref)
    # the sequence exercised the error paths too
    kinds = {entry[1] for entry in ref[::2] if len(entry) == 3}
    assert {"FrozenOriginError", "StaleBranchError"} & kinds


def test_double_release_guard_survives_python_O():
    """``python -O`` strips asserts; the port's guard must be a real raise
    (the JAX package's double-release probe in ``tests/test_kvbranch.py``,
    run against the port)."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = "\n".join([
        "from repro_torch.core import KVBranchManager",
        "from repro_torch.core.errors import BranchError, Errno",
        "kv = KVBranchManager(num_pages=8, page_size=4)",
        "sid = kv.new_seq(length=4)",
        "pages = kv.block_table(sid)",
        "kv.release(sid)",
        "try:",
        "    kv._decref(pages)",
        "except BranchError as e:",
        "    if e.errno is not Errno.EINVAL:",
        "        raise SystemExit(f'wrong errno: {e.errno!r}')",
        "    print('GUARDED', kv.free_pages)",
        "else:",
        "    raise SystemExit('double release silently succeeded under -O')",
    ])
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-O", "-c", code],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "GUARDED 8" in proc.stdout
