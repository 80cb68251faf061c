"""The import rule: a run loads neither JAX nor the JAX package, and the
reference reaches nothing of the port."""

import json
import subprocess
import sys

from benchlib import files

PROBE = """
import sys, runpy
sys.argv = ["bench/run.py", "--workload", "paper-agentic.agent-tiny",
            "--seed", "4", "--seconds", "1", "--trace", "0",
            "--device", "cpu", "--manifest", "bench/rehearsal.json"]
try:
    runpy.run_path("bench/run.py", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
print("MODULES", sorted({m.split(".")[0] for m in sys.modules}))
"""


def _top_level(out):
    line = [x for x in out.splitlines() if x.startswith("MODULES")][-1]
    return set(eval(line[len("MODULES "):]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=files.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    mods = _top_level(r.stdout)
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}
    result = json.loads([x for x in r.stdout.splitlines()
                         if x.startswith("{")][-1])
    assert result["correct"] is True


def test_the_reference_reaches_nothing_of_the_port():
    probe = (
        "import sys; sys.path.insert(0, 'bench');"
        "from benchlib import files;"
        "files.load_module(files.BENCH_DIR / 'reference' / 'decoder.py');"
        "print('MODULES', sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", probe], cwd=files.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    mods = _top_level(r.stdout)
    assert "torch" in mods
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    src = (files.BENCH_DIR / "reference" / "decoder.py").read_text()
    assert "repro" not in src.replace("this repository", "")


def test_the_shard_reference_reaches_nothing_of_the_port():
    probe = (
        "import sys; sys.path.insert(0, 'bench');"
        "from benchlib import files;"
        "files.load_module(files.BENCH_DIR / 'reference' / "
        "'decoder_shards.py');"
        "print('MODULES', sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", probe], cwd=files.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    mods = _top_level(r.stdout)
    assert "torch" in mods
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    src = (files.BENCH_DIR / "reference" / "decoder_shards.py").read_text()
    assert "repro" not in src.replace("this repository", "")
