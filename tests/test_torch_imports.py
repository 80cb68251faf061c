"""The port stands alone: no module of ``repro_torch``, no torch twin of
an example (``examples/*_torch.py``) and not ``chip_smoke.py`` imports
``jax`` or anything of the JAX package ``repro`` (``repro_torch`` itself
is fine).  Checked on the source, so a lazy import inside a function
counts too."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]


def forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_the_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/runtime/serve_loop.py" in names
    assert {f"examples/{n}_torch.py" for n in (
        "quickstart", "agentic_serve", "speculative_train",
        "train_100m")} <= names
    assert "examples/quickstart.py" not in names
    assert len(names) > 20


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_reference_imports(path):
    bad = [m for m in imported_modules(path) if forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_the_rule_catches_what_it_should():
    assert forbidden("jax.numpy") and forbidden("repro.obs")
    assert forbidden("repro") and not forbidden("repro_torch.obs")
    # the JAX examples the twins stand beside would fail the scan
    for name in ("quickstart", "agentic_serve", "speculative_train",
                 "train_100m"):
        assert any(forbidden(m) for m in imported_modules(
            ROOT / "examples" / f"{name}.py")), name
