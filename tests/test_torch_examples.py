"""The torch twins of ``examples/`` run to their markers on the CPU.

``examples/{quickstart,agentic_serve,speculative_train,train_100m}_torch.py``
are the port's twins of the reference's examples, held the way
``tests/test_examples.py`` holds those: each runs to its end and prints
the reference's marker lines.  They run in process with ``--device cpu``
(the kernels' plain versions); ``agentic_serve_torch.py --client`` drives
a port front door (``python -m repro_torch.launch.serve --serve``) started
here; one subprocess runs ``quickstart_torch.py`` as a script.  The 100M
and smoke configs equal the reference's field for field.

The twins' numbers differ from the reference's by design: the port draws
its samples from counter-based keys (``repro_torch.core.explore``), not
JAX's, so sampled tokens, winners and losses differ (ROADMAP §3).  Their
parity lives in the tests of what they drive: the engine and session
(``test_torch_serve_engine.py``, ``test_torch_api.py``), the exploration
driver (``test_torch_explore_ctx.py``), the front door
(``test_torch_server.py``), device-side explore
(``test_torch_explore_device.py``), BranchFS (``test_torch_branchfs.py``),
training and checkpoints (``test_torch_train.py``,
``test_torch_fault_tolerance.py``, ``test_torch_data_checkpoint.py``).
"""

import dataclasses
import importlib.util
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]
SERVING = re.compile(r"serving on (http://[0-9.]+:\d+) ")


def load(name):
    """An example script as a module (``examples/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(name, argv, capsys):
    load(name).main(argv)
    return capsys.readouterr().out


def test_quickstart_in_process(capsys):
    out = run("quickstart_torch", ["--device", "cpu"], capsys)
    assert "-ESTALE" in out
    assert "quickstart complete" in out
    assert "pool drained: 64/64" in out


def test_agentic_serve_in_process(capsys):
    out = run("agentic_serve_torch", ["--device", "cpu"], capsys)
    assert "committing branch" in out
    assert "final sequence" in out
    assert "'pages_free': 512" in out.splitlines()[-1]


def test_speculative_train_in_process(capsys):
    out = run("speculative_train_torch", ["--device", "cpu"], capsys)
    assert out.count("committed branch") == 15
    assert "speculative training complete" in out


def test_train_100m_smoke_in_process(capsys):
    out = run("train_100m_torch", ["--smoke", "--device", "cpu"], capsys)
    assert "->" in out  # loss improved line printed (assert inside)


def test_configs_are_the_reference_field_for_field():
    ref, port = load("train_100m"), load("train_100m_torch")
    for fn in ("config_100m", "config_smoke"):
        assert dataclasses.asdict(getattr(port, fn)()) == \
            dataclasses.asdict(getattr(ref, fn)()), fn


def test_quickstart_as_a_script():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "examples/quickstart_torch.py", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "quickstart complete" in r.stdout


def test_agentic_serve_client_against_a_port_front_door(capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--serve",
         "127.0.0.1:0", "--device", "cpu"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(240, proc.kill)
    watchdog.start()
    try:
        first = proc.stdout.readline()
        m = SERVING.match(first)
        assert m, f"{first!r} {proc.stderr.read()[-2000:]}"
        out = run("agentic_serve_torch", ["--client", m.group(1)], capsys)
        proc.send_signal(signal.SIGINT)
        rest, _ = proc.communicate(timeout=120)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    assert out.count("final sequence") == 3, out
    assert "drained cleanly" in rest
