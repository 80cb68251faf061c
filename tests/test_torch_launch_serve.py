"""Port parity: ``python -m repro_torch.launch.serve`` against the JAX
package's ``python -m repro.launch.serve``.

Both CLIs run their demo in process at ``--device cpu`` (the port) and on
the JAX CPU backend: ``paper-agentic`` at float32, page 8, the same
prompts, best-of-N per request through the exploration driver.  The two
packages draw their random weights and their sampling noise from
different streams, so the output is compared line for line on structure:
each request line's prompt, generated length, branch count, score count
and degradation note, and every line of the session's procfs view (the
branch forest and the pool/handle summary) exactly.
"""

import json
import re

import pytest
import torch

from repro.launch import serve as jax_cli
from repro_torch.launch import serve as port_cli

REQUEST = re.compile(r"request (\d+): prompt (\[[^\]]*\]) -> (\[[^\]]*\]) "
                     r"\(best of (\d+), scores (\[[^\]]*\])\)(.*)$")


def run(cli, argv, capsys):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out.splitlines()


def structure(lines):
    """Each line reduced to what both packages must share."""
    out = []
    for ln in lines:
        m = REQUEST.match(ln)
        if m:
            r, prompt, gen, n, scores, note = m.groups()
            out.append(("request", int(r), json.loads(prompt),
                        len(json.loads(gen)), int(n),
                        len(json.loads(scores.replace("'", '"'))), note))
        elif ln.startswith("  ") and not ln.lstrip().startswith("seq "):
            # a metrics line: a counter whole (it counts structure), a
            # gauge or histogram by kind and name (its values are times)
            kind, name = ln.split()[:2]
            out.append(ln if kind == "counter" else ("metric", kind, name))
        elif ln.startswith("wrote "):
            out.append(("wrote",))
        else:
            out.append(ln)
    return out


CASES = {
    "default": ["--tokens", "4", "--requests", "2", "--branches", "2"],
    "three_requests": ["--tokens", "3", "--requests", "3", "--branches", "3",
                       "--max-batch", "4", "--no-prefix-cache"],
    "page_pressure": ["--tokens", "2", "--requests", "1", "--branches",
                      "300", "--num-pages", "64"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_output_matches_the_reference_structure(case, capsys):
    argv = CASES[case]
    jrc, jlines = run(jax_cli, argv, capsys)
    prc, plines = run(port_cli, argv + ["--device", "cpu"], capsys)
    assert prc == jrc == 0
    assert "session tree (procfs view):" in plines
    assert plines[-1].endswith("handles: 0 open")
    assert structure(plines) == structure(jlines)
    if case == "page_pressure":
        assert plines[0].endswith("(degraded: page pressure)")


def test_trace_writes_a_timeline_and_the_metrics_block(capsys, tmp_path):
    argv = ["--tokens", "2", "--requests", "1", "--branches", "2"]
    jtrace, ptrace = tmp_path / "jax.json", tmp_path / "port.json"
    jrc, jlines = run(jax_cli, argv + ["--trace", str(jtrace)], capsys)
    prc, plines = run(port_cli, argv + ["--device", "cpu", "--trace",
                                        str(ptrace)], capsys)
    assert prc == jrc == 0
    assert "metrics:" in plines
    assert structure(plines) == structure(jlines)
    events = json.loads(ptrace.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert names == {e["name"] for e in json.loads(
        jtrace.read_text())["traceEvents"]}


@pytest.mark.parametrize("flag, item", [(["--tp", "2"], "multi-GPU"),
                                        (["--serve", "127.0.0.1:0"],
                                         "front door")])
def test_unported_modes_refuse_and_name_their_roadmap_item(flag, item,
                                                           capsys):
    rc = port_cli.main(flag + ["--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 2
    assert "not ported yet" in err and "ROADMAP" in err and item in err


def test_the_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--tokens", "1", "--requests", "1"])
