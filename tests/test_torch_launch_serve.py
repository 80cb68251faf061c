"""Port parity: ``python -m repro_torch.launch.serve`` against the JAX
package's ``python -m repro.launch.serve``.

Both CLIs run their demo in process at ``--device cpu`` (the port) and on
the JAX CPU backend: ``paper-agentic`` at float32, page 8, the same
prompts, best-of-N per request through the exploration driver.  The two
packages draw their random weights and their sampling noise from
different streams, so the output is compared line for line on structure:
each request line's prompt, generated length, branch count, score count
and degradation note, and every line of the session's procfs view (the
branch forest and the pool/handle summary) exactly.  In ``--serve`` mode
both run as subprocesses on port 0: the address line, one request through
``ServeClient``, and the drain after SIGINT are compared the same way.
"""

import asyncio
import json
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from repro.launch import serve as jax_cli
from repro_torch.launch import serve as port_cli
from repro_torch.obs import ENGINE_TRACK
from repro_torch.server import ServeClient
from torch_parity import shared_metric_lines

ROOT = Path(__file__).resolve().parents[1]
#: the reference's histogram the port does not keep: its clock stopped at
#: the prefill's enqueue; the port's traced engine records an
#: ``engine.add_request`` span with the prefill's phases instead
NOT_PORTED = ("metric", "hist", "engine.prefill_us")

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
    plines = shared_metric_lines(True, plines)
    want = structure(shared_metric_lines(False, jlines))
    assert NOT_PORTED in want and NOT_PORTED not in structure(plines)
    assert structure(plines) == [x for x in want if x != NOT_PORTED]
    events = json.loads(ptrace.read_text())["traceEvents"]
    # the engine track's complete spans (the serving path's phases) are the
    # port's alone; tests/test_torch_engine_spans.py holds them
    spans = {e["name"] for e in events
             if e["ph"] == "X" and e["tid"] == ENGINE_TRACK}
    assert {"driver.step", "engine.decode", "engine.add_request"} <= spans
    names = {e["name"] for e in events
             if not (e["ph"] == "X" and e["tid"] == ENGINE_TRACK)}
    assert names == {e["name"] for e in json.loads(
        jtrace.read_text())["traceEvents"]}


@pytest.mark.parametrize("flag, item", [
    pytest.param(["--tp", "2"], "serving mesh: tp=2 over [cpu, cpu]",
                 id="flag0-multi-GPU")])
def test_unported_modes_refuse_and_name_their_roadmap_item(flag, item,
                                                           capsys):
    """The modes once refused here (``--tp``, the ROADMAP's multi-GPU
    item) now run: ``--device cpu --tp 2`` serves through a two-shard
    engine and prints the reference's serving-mesh line."""
    jrc, jlines = run(jax_cli, ["--tokens", "2", "--requests", "1"], capsys)
    rc, lines = run(port_cli, flag + ["--device", "cpu", "--tokens", "2",
                                      "--requests", "1"], capsys)
    assert rc == jrc == 0
    assert lines[0] == item
    assert lines[-1].endswith("handles: 0 open")
    assert structure(lines[1:]) == structure(jlines)


SERVING = re.compile(r"serving on http://([0-9.]+):(\d+) \(tenants: (.*)\)$")


def serve_cli(module, extra):
    """Start ``python -m <module> --serve 127.0.0.1:0``, send one greedy
    ``/v1/generate`` through ``ServeClient`` to the address it prints,
    then SIGINT it.  Returns its output lines, exit code and the
    request's terminal event."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get(
            "PYTHONPATH") else []))
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--serve", "127.0.0.1:0",
         "--tenants", "interactive:4:2,batch:2:1", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    watchdog = threading.Timer(180, proc.kill)
    watchdog.start()
    try:
        first = proc.stdout.readline().rstrip("\n")
        m = SERVING.match(first)
        assert m, f"{module}: {first!r} {proc.stderr.read()[-2000:]}"
        client = ServeClient(f"http://{m.group(1)}:{m.group(2)}")
        fin = asyncio.run(client.generate([1, 2, 3], tenant="interactive",
                                          max_new_tokens=4))
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return [first] + out.splitlines(), proc.returncode, fin


def test_serve_mode_serves_then_drains_like_the_reference():
    plines, prc, pfin = serve_cli("repro_torch.launch.serve",
                                  ["--device", "cpu"])
    jlines, jrc, jfin = serve_cli("repro.launch.serve", [])
    assert prc == jrc == 0
    # the addresses differ (port 0); the tenants and the rest do not
    assert SERVING.match(plines[0]).group(3) == \
        SERVING.match(jlines[0]).group(3) == \
        "['default', 'interactive', 'batch']"
    assert plines[1:] == jlines[1:] == [
        "draining...", "drained cleanly (0 parked/stale evicted)"]
    # the packages' seeded weights differ: the request on structure
    for fin in (pfin, jfin):
        assert fin["event"] == "finished" and fin["tokens"][:3] == [1, 2, 3]
        assert len(fin["generated"]) == 4
    assert sorted(pfin) == sorted(jfin)


def test_the_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--tokens", "1", "--requests", "1"])
