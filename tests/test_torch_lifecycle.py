"""Port parity: the BranchTree kernel (``repro_torch.core.lifecycle``)
against the JAX package's ``repro.core.lifecycle``.

Each scenario of ``tests/test_lifecycle.py`` runs once per package on a
fresh ``BranchTree`` of that package, with the same toy payload domains,
keeps the reference test's own asserts, and returns a record — ids,
statuses, epochs, groups, the domain hooks' event order and the class of
every refusal — that must be equal across the two.
"""

import threading

import pytest

import repro.core.errors as jax_errors
import repro.core.lifecycle as jax_lifecycle
import repro_torch.core.errors as port_errors
import repro_torch.core.lifecycle as port_lifecycle

PKGS = {"jax": (jax_lifecycle, jax_errors),
        "port": (port_lifecycle, port_errors)}


class DictDomain:
    """Minimal payload domain: one value per branch, CoW on fork."""

    def __init__(self):
        self.data = {}
        self.events = []

    def on_fork(self, parent, children):
        self.events.append(("fork", parent, tuple(children)))
        for c in children:
            self.data[c] = self.data.get(parent)

    def on_commit(self, child, parent):
        self.events.append(("commit", child, parent))
        self.data[parent] = self.data.pop(child)

    def on_abort(self, branch):
        self.events.append(("abort", branch))
        self.data.pop(branch, None)

    def on_invalidate(self, branch):
        self.events.append(("invalidate", branch))
        self.data.pop(branch, None)


def refusal(fn, *args, **kw):
    with pytest.raises(Exception) as exc:
        fn(*args, **kw)
    errno = getattr(exc.value, "errno", None)
    return type(exc.value).__name__, getattr(errno, "name", errno)


def statuses(L, tree, ids):
    return [tree.status(i).name for i in ids]


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def first_commit_wins_bumps_epoch_and_invalidates(L, E, tree):
    root = tree.create_root()
    a, b, c = tree.fork(root, 3)
    assert tree.commit(a) == root
    assert tree.status(a) is L.BranchStatus.COMMITTED
    assert tree.status(b) is L.BranchStatus.STALE
    assert tree.status(c) is L.BranchStatus.STALE
    with pytest.raises(E.StaleBranchError):
        tree.commit(b)
    assert tree.epoch(root) == 1
    return ([root, a, b, c], statuses(L, tree, [root, a, b, c]),
            refusal(tree.commit, c), tree.epoch(root))


@scenario
def exclusive_group_shared_per_fork_batch(L, E, tree):
    root = tree.create_root()
    batch1 = tree.fork(root, 2)
    g1 = {tree.node(b).group for b in batch1}
    assert len(g1) == 1
    tree.commit(batch1[0])
    batch2 = tree.fork(root, 2)
    g2 = {tree.node(b).group for b in batch2}
    assert len(g2) == 1 and g1 != g2
    return batch1, batch2, sorted(g1), sorted(g2)


@scenario
def freeze_on_fork_and_resume(L, E, tree):
    root = tree.create_root()
    a, b = tree.fork(root, 2)
    seen = [tree.status(root).name]
    assert tree.status(root) is L.BranchStatus.FROZEN
    tree.abort(a)
    assert tree.status(root) is L.BranchStatus.FROZEN  # b still live
    seen.append(tree.status(root).name)
    tree.abort(b)
    assert tree.status(root) is L.BranchStatus.ACTIVE  # all resolved
    return seen + statuses(L, tree, [root, a, b])


@scenario
def commit_unfreezes_parent(L, E, tree):
    root = tree.create_root()
    a, b = tree.fork(root, 2)
    tree.commit(b)
    assert tree.status(root) is L.BranchStatus.ACTIVE
    return statuses(L, tree, [root, a, b])


@scenario
def no_freeze_tree_keeps_parent_active(L, E, tree):
    t = L.BranchTree(freeze_on_fork=False, allow_fork_resolved=True)
    root = t.create_root()
    (a,) = t.fork(root, 1)
    assert t.status(root) is L.BranchStatus.ACTIVE
    assert t.has_live_children(root)
    t.commit(a)
    # committed nodes remain forkable in allow_fork_resolved trees
    (aa,) = t.fork(a, 1)
    with pytest.raises(E.BranchStateError):
        L.BranchTree(allow_fork_resolved=False).fork(0, 1)
    return (statuses(L, t, [root, a, aa]),
            refusal(L.BranchTree(allow_fork_resolved=False).fork, 0, 1))


@scenario
def recursive_invalidation_reaches_grandchildren(L, E, tree):
    root = tree.create_root()
    a, b = tree.fork(root, 2)
    (g,) = tree.fork(b, 1)
    tree.commit(a)
    assert tree.status(b) is L.BranchStatus.STALE
    assert tree.status(g) is L.BranchStatus.STALE
    return statuses(L, tree, [root, a, b, g])


@scenario
def commit_with_live_children_rejected(L, E, tree):
    root = tree.create_root()
    (a,) = tree.fork(root, 1)
    tree.fork(a, 2)
    with pytest.raises(E.BranchStateError):
        tree.commit(a)
    return refusal(tree.commit, a)


@scenario
def root_cannot_commit(L, E, tree):
    root = tree.create_root()
    with pytest.raises(E.BranchStateError):
        tree.commit(root)
    return refusal(tree.commit, root)


@scenario
def domain_hooks_fire_in_order(L, E, tree):
    dom = DictDomain()
    tree.attach(dom)
    root = tree.create_root()
    dom.data[root] = "base"
    a, b = tree.fork(root, 2)
    assert dom.data[a] == dom.data[b] == "base"
    dom.data[a] = "winner"
    tree.commit(a)
    assert dom.data[root] == "winner"
    assert a not in dom.data           # moved, not copied
    assert b not in dom.data           # invalidated payload reclaimed
    kinds = [e[0] for e in dom.events]
    assert kinds == ["fork", "commit", "invalidate"]
    return dom.events, dom.data


@scenario
def two_domains_resolve_atomically(L, E, tree):
    d1, d2 = DictDomain(), DictDomain()
    tree.attach(d1)
    tree.attach(d2)
    root = tree.create_root()
    d1.data[root], d2.data[root] = "fs", "mem"
    a, b = tree.fork(root, 2)
    d1.data[a], d2.data[a] = "fs'", "mem'"
    tree.commit(a)
    # one kernel-level commit moved BOTH payloads; the loser lost both
    assert (d1.data[root], d2.data[root]) == ("fs'", "mem'")
    assert b not in d1.data and b not in d2.data
    return d1.events, d2.events, d1.data, d2.data


@scenario
def abort_after_estale_refires_idempotent_cleanup(L, E, tree):
    dom = DictDomain()
    tree.attach(dom)
    root = tree.create_root()
    a, b = tree.fork(root, 2)
    tree.commit(a)
    tree.abort(b)   # cleanup-after-ESTALE: allowed, idempotent
    assert [e[0] for e in dom.events].count("invalidate") == 2
    assert tree.status(b) is L.BranchStatus.STALE
    return dom.events, statuses(L, tree, [root, a, b])


@scenario
def invalidate_evicts_roots_and_subtrees(L, E, tree):
    dom = DictDomain()
    tree.attach(dom)
    root = tree.create_root()
    dom.data[root] = "x"
    a, b = tree.fork(root, 2)
    tree.invalidate(root, status=L.BranchStatus.ABORTED)
    assert tree.status(root) is L.BranchStatus.ABORTED
    assert tree.status(a) is L.BranchStatus.STALE
    assert tree.status(b) is L.BranchStatus.STALE
    assert not dom.data
    return dom.events, statuses(L, tree, [root, a, b])


@scenario
def concurrent_commits_single_winner(L, E, tree):
    root = tree.create_root()
    n = 8
    branches = tree.fork(root, n)
    results = [None] * n
    barrier = threading.Barrier(n)

    def racer(i, bid):
        barrier.wait()
        try:
            tree.commit(bid)
            results[i] = "won"
        except E.StaleBranchError:
            results[i] = "stale"

    ts = [threading.Thread(target=racer, args=(i, b))
          for i, b in enumerate(branches)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts)
    assert results.count("won") == 1
    assert results.count("stale") == n - 1
    assert tree.epoch(root) == 1
    # which racer wins is the scheduler's choice: the counts are shared
    return sorted(results), tree.epoch(root), sorted(
        statuses(L, tree, branches))


@scenario
def lazy_stale_detection_via_epoch(L, E, tree):
    root = tree.create_root()
    a, b = tree.fork(root, 2)
    tree.commit(a)
    tree.node(b).status = L.BranchStatus.ACTIVE
    with pytest.raises(E.StaleBranchError):
        tree.check_live(b)
    assert tree.status(b) is L.BranchStatus.STALE
    return statuses(L, tree, [root, a, b])


@scenario
def unknown_branch_raises(L, E, tree):
    with pytest.raises(E.BranchStateError):
        tree.node(999)
    assert not tree.is_live(999)
    return refusal(tree.node, 999), tree.is_live(999)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(name):
    records = {pkg: SCENARIOS[name](L, E, L.BranchTree(freeze_on_fork=True))
               for pkg, (L, E) in PKGS.items()}
    assert records["port"] == records["jax"]
