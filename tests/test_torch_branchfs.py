"""Port parity: BranchFS on disk (``repro_torch.fs``) against the JAX
package's ``repro.fs``.

Each scenario of ``tests/test_branchfs.py`` runs once per package on a
fresh store of that package, keeps the reference test's own asserts, and
returns a record — bytes read, statuses, epochs, ``delta_paths``, listings,
chunk counts, the CLI's output and the class of every refusal — that must
be equal across the two.  ``test_branchfs_matches_model`` of
``tests/test_property_store.py`` runs the same hypothesis op sequences
against both packages' ``BranchFS`` in lockstep: after every op the
result or the refusal's class, and every branch's status, epoch, delta
paths, listing and bytes, are equal.
"""

import pytest

import repro.core.errors as jax_errors
import repro.fs as jax_fs
import repro.fs.cli as jax_cli
import repro_torch.core.errors as port_errors
import repro_torch.fs as port_fs
import repro_torch.fs.cli as port_cli

PKGS = {"jax": (jax_fs, jax_errors, jax_cli),
        "port": (port_fs, port_errors, port_cli)}


def refusal(fn, *args, **kw):
    with pytest.raises(Exception) as exc:
        fn(*args, **kw)
    return type(exc.value).__name__


def fresh(F, root):
    fs = F.BranchFS(root / "ws")
    fs.write("base", "main.py", b"print('hello')")
    fs.write("base", "lib/util.py", b"def f(): pass")
    return fs


def view(fs):
    """Every branch's status, epoch, delta paths and listing."""
    return {b: (fs.status(b), fs.epoch(b), fs.delta_paths(b),
                fs.listdir(b)) for b in fs.branches()}


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def create_and_chain_read(F, E, C, root, capsys):
    fs = fresh(F, root)
    (b,) = fs.create()
    assert fs.read(b, "main.py") == b"print('hello')"
    return b, fs.read(b, "main.py"), view(fs)


@scenario
def cow_write_isolates_base(F, E, C, root, capsys):
    fs = fresh(F, root)
    (b,) = fs.create()
    fs.write(b, "main.py", b"print('patched')")
    assert fs.read(b, "main.py") == b"print('patched')"
    assert fs.read("base", "main.py") == b"print('hello')"
    return view(fs), fs.obs.metrics.snapshot()["counters"]


@scenario
def at_branch_paths(F, E, C, root, capsys):
    fs = fresh(F, root)
    fs.create(name="feature-a")
    fs.write("base", "@feature-a/new.txt", b"x")  # @path overrides branch
    assert fs.read("base", "@feature-a/new.txt") == b"x"
    assert not fs.exists("base", "new.txt")
    return view(fs)


@scenario
def tombstones(F, E, C, root, capsys):
    fs = fresh(F, root)
    (b,) = fs.create()
    fs.delete(b, "main.py")
    with pytest.raises(E.NoSuchLeafError):
        fs.read(b, "main.py")
    assert "main.py" not in fs.listdir(b)
    assert fs.read("base", "main.py") == b"print('hello')"
    return view(fs), refusal(fs.read, b, "main.py"), refusal(
        fs.delete, b, "main.py")


@scenario
def commit_to_parent_and_sibling_invalidation(F, E, C, root, capsys):
    fs = fresh(F, root)
    b1, b2 = fs.create(n=2)
    fs.write(b1, "main.py", b"v1")
    fs.write(b2, "main.py", b"v2")
    parent = fs.commit(b1)
    assert fs.read("base", "main.py") == b"v1"
    assert fs.status(b2) == "stale"
    with pytest.raises(E.StaleBranchError):
        fs.commit(b2)
    return parent, view(fs), refusal(fs.write, b2, "x", b"1"), \
        fs.chunks.stats()["chunks"]


@scenario
def nested_commit_one_level(F, E, C, root, capsys):
    fs = fresh(F, root)
    (b,) = fs.create()
    (bb,) = fs.create(parent=b)
    fs.write(bb, "deep.txt", b"d")
    fs.commit(bb)
    assert fs.read(b, "deep.txt") == b"d"
    assert not fs.exists("base", "deep.txt")
    mid = view(fs)
    fs.commit(b)
    assert fs.read("base", "deep.txt") == b"d"
    return mid, view(fs)


@scenario
def abort_recycles_chunks(F, E, C, root, capsys):
    fs = fresh(F, root)
    (b,) = fs.create()
    fs.write(b, "junk.bin", b"Z" * 1024)
    before = fs.chunks.stats()["chunks"]
    fs.abort(b)
    assert fs.chunks.stats()["chunks"] == before - 1
    assert fs.status(b) == "aborted"
    return before, fs.chunks.stats(), view(fs)


@scenario
def frozen_origin_on_disk(F, E, C, root, capsys):
    fs = fresh(F, root)
    (b,) = fs.create()
    fs.create(parent=b)
    with pytest.raises(E.FrozenOriginError):
        fs.write(b, "x", b"1")
    return refusal(fs.delete, b, "main.py"), view(fs)


@scenario
def persistence_across_reopen(F, E, C, root, capsys):
    fs = fresh(F, root)
    (b,) = fs.create(name="persist")
    fs.write(b, "main.py", b"v2")
    fs.commit(b)
    fs2 = F.BranchFS(root / "ws")
    assert fs2.read("base", "main.py") == b"v2"
    assert fs2.status("persist") == "committed"
    return view(fs2), fs2.read("base", "lib/util.py")


@scenario
def identical_content_stored_once(F, E, C, root, capsys):
    fs = fresh(F, root)
    (b,) = fs.create()
    before = fs.chunks.stats()["chunks"]
    fs.write(b, "copy1.bin", b"same-bytes")
    fs.write(b, "copy2.bin", b"same-bytes")
    assert fs.chunks.stats()["chunks"] == before + 1  # content-addressed
    return before, fs.chunks.stats()


@scenario
def base_commit_into_base_is_error(F, E, C, root, capsys):
    fs = fresh(F, root)
    with pytest.raises(E.BranchStateError):
        fs.commit("base")
    return refusal(fs.commit, "base"), refusal(fs.commit, "nope")


@scenario
def chunkstore_refcount_gc(F, E, C, root, capsys):
    cs = F.ChunkStore(root / "cs")
    cid = cs.put(b"hello")
    assert cs.refcount(cid) == 1
    cs.incref([cid])
    assert cs.refcount(cid) == 2
    cs.decref([cid])
    assert cs.exists(cid)
    cs.decref([cid])
    assert not cs.exists(cid)  # GC'd at zero
    return cid, cs.refcount(cid), cs.stats()


@scenario
def cli_roundtrip(F, E, C, root, capsys):
    ws = str(root / "cliws")
    capsys.readouterr()
    C.main(["--root", ws, "init"])
    C.main(["--root", ws, "write", "--branch", "base",
            "--path", "f.txt", "--data", "orig"])
    C.main(["--root", ws, "create", "--parent", "base", "--name", "fix"])
    C.main(["--root", ws, "write", "--branch", "fix",
            "--path", "f.txt", "--data", "patched"])
    C.main(["--root", ws, "commit", "--branch", "fix"])
    C.main(["--root", ws, "status", "--branch", "fix"])
    C.main(["--root", ws, "ls", "--branch", "base"])
    log = capsys.readouterr().out.replace(ws, "<root>")
    C.main(["--root", ws, "read", "--branch", "base", "--path", "f.txt"])
    assert capsys.readouterr().out == "patched"
    return log


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(name, tmp_path, capsys):
    records = {}
    for pkg, (F, E, C) in PKGS.items():
        root = tmp_path / pkg
        root.mkdir()
        records[pkg] = SCENARIOS[name](F, E, C, root, capsys)
    assert records["port"] == records["jax"]


# ---------------------------------------------------------------------------
# tests/test_property_store.py::test_branchfs_matches_model, both packages
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip(
    "hypothesis", reason="optional test dep, as in test_property_store.py")
st = hypothesis.strategies

KEYS = ["a", "b", "c", "d/e"]
op_st = st.one_of(
    st.tuples(st.just("fork"), st.integers(0, 5), st.integers(1, 3)),
    st.tuples(st.just("write"), st.integers(0, 8), st.sampled_from(KEYS),
              st.integers(0, 99)),
    st.tuples(st.just("delete"), st.integers(0, 8), st.sampled_from(KEYS)),
    st.tuples(st.just("commit"), st.integers(1, 8)),
    st.tuples(st.just("abort"), st.integers(1, 8)),
)


def apply(fs, ids, op):
    """One op on one store; its result, or the class of its refusal.
    ``ids`` maps op indices to branch names (the base is index 0)."""
    kind = op[0]
    try:
        if kind == "fork":
            _, parent, n = op
            if parent not in ids:
                return "skip"
            new = fs.create(parent=ids[parent], n=n)
            for name in new:
                ids[len(ids)] = name
            return new
        b = op[1]
        if b not in ids:
            return "skip"
        if kind == "write":
            return fs.write(ids[b], op[2], str(op[3]).encode())
        if kind == "delete":
            return fs.delete(ids[b], op[2])
        if kind == "commit":
            return fs.commit(ids[b])
        return fs.abort(ids[b])
    except Exception as err:   # the refusal's class is the record
        return type(err).__name__


def snapshot(fs, E):
    out = {}
    for b in fs.branches():
        files = {}
        for path in fs.listdir(b):
            try:
                files[path] = fs.read(b, path)
            except E.BranchError as err:
                files[path] = type(err).__name__
        out[b] = (fs.status(b), fs.epoch(b), fs.delta_paths(b), files)
    return out


@hypothesis.settings(max_examples=30, deadline=None,
                     suppress_health_check=[
                         hypothesis.HealthCheck.too_slow,
                         hypothesis.HealthCheck.function_scoped_fixture])
@hypothesis.given(st.lists(op_st, max_size=12))
def test_branchfs_matches_reference_op_for_op(tmp_path_factory, ops):
    root = tmp_path_factory.mktemp("ops")
    stores = {}
    for pkg, (F, E, C) in PKGS.items():
        fs = F.BranchFS(root / pkg)
        for k, v in {"a": 0, "b": 1}.items():
            fs.write("base", k, str(v).encode())
        stores[pkg] = (fs, E, {0: "base"})
    for i, op in enumerate(ops):
        got = {pkg: apply(fs, ids, op) for pkg, (fs, E, ids) in stores.items()}
        assert got["port"] == got["jax"], f"op {i} {op}"
        views = {pkg: snapshot(fs, E) for pkg, (fs, E, ids) in stores.items()}
        assert views["port"] == views["jax"], f"after op {i} {op}"
    for fs, E, ids in stores.values():
        fs.close()
