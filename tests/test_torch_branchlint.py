"""branchlint (``repro.analysis``, the JAX package's stdlib-only protocol
checker) over the port: ``src/repro_torch`` must have no finding, with no
baseline.  The port's session and exploration driver are copies of the
code where branchlint's first run found the mid-vector unwind leak, so the
same rules hold them.  A mutated copy of the port's session shows the run
would see a leak if one came back."""

from pathlib import Path

from repro.analysis import analyze_paths

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_the_port_has_no_branchlint_finding():
    result = analyze_paths([str(PORT)])
    assert result.parse_errors == []
    assert result.findings == [], "\n".join(
        f"{f.file}:{f.line}: {f.rule} {f.message}" for f in result.findings)
    # it walked the whole port, the host slice included
    assert result.files_checked >= len(list(PORT.rglob("*.py"))) > 40
    # the two suppressions are the reference's own: the runtime's
    # best-effort unwind and BranchFS's interpreter-teardown close
    assert result.suppressed == 2
    suppressing = sorted(
        p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")
        if "branchlint: ignore" in p.read_text())
    assert suppressing == ["core/runtime_api.py", "fs/branchfs.py"]


def test_a_leaked_handle_in_the_port_session_is_seen(tmp_path):
    src = (PORT / "api" / "session.py").read_text()
    leak = '''
def leaky(session, parent):
    kids = session.branch(parent, 0, 2)
    if not kids:
        return None
    return len(kids)
'''
    bad = tmp_path / "session_leak.py"
    bad.write_text(src + leak)
    result = analyze_paths([str(bad)])
    assert [f.rule for f in result.findings] == ["BL002"]
