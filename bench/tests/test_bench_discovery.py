"""A configuration, a traffic mix and a metric added as files only are found
by name."""

import json
import shutil

from benchlib import files


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "limits", "metrics", "reference"):
        (bench / sub).mkdir(parents=True)
    shutil.copy(files.BENCH_DIR / "configs" / "paper-agentic.json",
                bench / "configs" / "tiny-new.json")
    (bench / "traffic" / "burst-new.json").write_text(json.dumps(
        {"sessions": 2, "shared_prefix_tokens": 8,
         "history_tokens": [8, 16, "uniform"],
         "tool_tokens": [2, 4, "uniform"],
         "branch_tokens": [2, 4, "uniform"], "max_context_tokens": 64,
         "branches": 2, "greedy_branches": 1, "temperature": 1.0,
         "max_batch": 4}))
    (bench / "limits" / "tiny-new.burst-new.json").write_text(json.dumps(
        {"max_gap": 0.5, "min_greedy_tokens": 1, "sample_tokens": 8,
         "sample_context": 100}))
    (bench / "metrics" / "new_metric.x.py").write_text(
        "def read(run):\n    return 42.0\n")
    manifest = tmp_path / "BENCHMARK.json"
    manifest.write_text(json.dumps({
        "configs": [{"name": "tiny-new",
                     "file": "bench/configs/tiny-new.json"}],
        "workloads": [{"name": "tiny-new.burst-new", "config": "tiny-new",
                       "traffic": "burst-new", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "new_metric.x", "unit": "ms",
                       "workloads": ["tiny-new.burst-new"]},
                      {"name": "elsewhere", "unit": "ms",
                       "workloads": ["other.cell"]}]}))
    cell = files.load_cell("tiny-new.burst-new", manifest, bench)
    assert cell.traffic["sessions"] == 2
    assert cell.limits["max_gap"] == 0.5
    assert cell.config["model"]["d_model"] == 256
    assert [m["name"] for m in cell.per_layer] == ["new_metric.x"]
    assert files.metric_reader("new_metric.x", bench).read(None) == 42.0
