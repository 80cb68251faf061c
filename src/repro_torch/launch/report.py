"""The dry-run and roofline tables from ``experiments/dryrun_torch/*.json``.

The port's counterpart of ``repro/launch/report.py``: the same three
tables, read from either package's records (a port record's ``hlo_*``
numbers are the op counter's: ``"counter": "torch_dispatch"``).  The
decode efficiency divides the ideal bytes by the H100's HBM rate.

Usage:  python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional


def load(dir_: Path) -> List[Dict]:
    rows = []
    for f in sorted(dir_.glob("*.json")):
        rows.append(json.loads(f.read_text()))
    return rows


def fmt_bytes(b) -> str:
    if b is None:
        return "—"
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}EB"


def dryrun_table(rows: List[Dict], mesh: str) -> str:
    out = ["| arch | shape | status | bytes/device | lower+compile (s) | "
           "collectives (count) |",
           "|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | SKIP | — | — | "
                       f"{r['reason'][:60]}… |")
            continue
        bpd = r.get("bytes_per_device")
        cc = r.get("coll_counts", {})
        cstr = " ".join(f"{k.split('-')[-1]}×{v}" for k, v in cc.items())
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {fmt_bytes(bpd)} | "
            f"{r.get('lower_s', 0)}+{r.get('compile_s', 0)} | {cstr} |")
    return "\n".join(out)


def cell_note(r: Dict) -> str:
    """One sentence: what would move the dominant term down."""
    kind = ("train" if r["shape"].startswith("train") else
            "prefill" if r["shape"].startswith("prefill") else "decode")
    b = r["bottleneck"]
    coll = r.get("coll_by_op", {})
    ag = coll.get("all-gather", 0)
    ar = coll.get("all-reduce", 0)
    if b == "collective" and ag >= ar:
        return ("FSDP weight re-gather dominates — fewer/larger "
                "microbatches or TP-resident weights")
    if b == "collective" and kind == "train":
        return ("gradient all-reduce dominates — reduce-scatter layout "
                "+ int8 compression (4×) on the cross-pod hop")
    if b == "collective":
        return ("the model axis' activation all-reduce dominates — fewer "
                "model positions for this cell, or its sums kept in NVLink")
    if b == "memory" and kind == "decode":
        return ("KV-cache streaming — the paged kernel reads the cache "
                "once in its type; int8 KV would halve it")
    if b == "memory" and kind == "train":
        return ("activation traffic (remat recompute + fp32 casts) — "
                "tune accum; flash/SSD kernels keep score tiles on chip")
    if b == "memory":
        return ("eager op traffic — fused kernels keep intermediates on "
                "chip; longer attn chunks amortize KV re-reads")
    return "compute-bound — causal block-skip halves attention FLOPs"


def decode_efficiency(r: Dict) -> Optional[float]:
    """Decode roofline: ideal (params+KV once) / achieved memory time."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.mesh import HBM_BW

    if not r["shape"].startswith(("decode", "long")):
        return None
    cfg = get_config(r["arch"])
    s = SHAPES[r["shape"]]
    n = (cfg.active_param_count() if cfg.is_moe else cfg.param_count())
    kv = cfg.kv_bytes_per_token() * s.seq_len * s.global_batch
    if cfg.family in ("ssm", "hybrid"):
        kv += (cfg.num_layers * s.global_batch * cfg.ssm_heads
               * cfg.ssm_state * cfg.ssm_head_dim * 4)
    ideal = (2 * n + kv) / (r["chips"] * HBM_BW)
    return ideal / r["t_memory_s"] if r["t_memory_s"] else None


def roofline_table(rows: List[Dict], mesh: str = "single") -> str:
    out = ["| arch | shape | compute s | memory s | collective s | "
           "bottleneck | useful-FLOPs | roofline | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh or r["status"] != "ok":
            continue
        rf = r["roofline_fraction"]
        de = decode_efficiency(r)
        rf_str = (f"{rf:.4f}" if de is None
                  else f"{de:.4f} (mem-ideal)")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4f} | "
            f"{r['t_memory_s']:.4f} | {r['t_collective_s']:.4f} | "
            f"{r['bottleneck']} | {r['useful_flops_ratio']:.3f} | "
            f"{rf_str} | {cell_note(r)} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    rows = load(Path(args.dir))
    print("## Dry-run (single-pod 16×16 = 256 cards)\n")
    print(dryrun_table(rows, "single"))
    print("\n## Dry-run (multi-pod 2×16×16 = 512 cards)\n")
    print(dryrun_table(rows, "multi"))
    print("\n## Roofline (single-pod)\n")
    print(roofline_table(rows, "single"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
