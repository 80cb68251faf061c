"""BENCHMARK.json against the rules of its format: names, units, keys, and
every file each entry names, found by name."""

import re

from benchlib import files

MAN = files.load_json(files.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51


def test_names_and_units():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind, e["name"]))
    assert len(set(names)) == len(names)
    for e in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for e in MAN["end_to_end"]:
        assert set(e) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in MAN["per_layer"]:
        assert set(e) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert e["moves"] in {m["name"] for m in MAN["end_to_end"]}


def test_every_cell_reports_enough_and_its_files_exist():
    cells = {w["name"] for w in MAN["workloads"]}
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= 1
    for w in MAN["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        cell = files.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert callable(files.metric_reader(m["name"]).read)
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        cfg = files.load_json(files.ROOT / c["file"])
        assert cfg["name"] == c["name"] and c["file"].startswith("bench/")
        assert set(c["reduced"]) <= set(cfg["model"]) | {"n_layers"}
        assert not any(k.endswith(("_dim", "_rank")) or k in (
            "d_model", "d_ff", "experts_per_token") for k in c["reduced"])
