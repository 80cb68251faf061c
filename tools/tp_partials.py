#!/usr/bin/env python3
"""How far tensor parallelism moves an MoE config from one device, on the
card, with the shards' partials summed two ways.

Run from the repository root on a machine with one CUDA card:

    python3 tools/tp_partials.py [--layers 4] [--seeds 0 1 2]

``dbrx-132b`` at full width, cut to ``--layers`` layers, bf16, is served
at tp 1 and at tp 4 with every shard on cuda:0 (weights drawn shard by
shard, 12 heads over 2 kv heads and 4 experts a shard) through
``chip_smoke.py`` phase 14 (d)'s load: four prompts of 1024, 768, 384 and
128 tokens, 4 branches each, one fused decode step at b 16.  For each
seed it prints the share of the first routing call's rows (layer 0 of the
first prompt) that tp 4 routes as tp 1 does, and the first decode step's
logits against tp 1 (relative RMS, whole and by row), with the partials
(attention ``wo``, the MLP's ``wd``, Mamba2's ``out_proj``) kept in f32
and rounded once after the sum (``layers.partial_product``, the port's
arithmetic) and, patched in, rounded to bf16 each and summed in bf16.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import serving_mesh, serving_plan  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.runtime import ServeEngine  # noqa: E402


def first_step(model, params, seed, **engine):
    """Phase 14 (d)'s load: the first fused step's logits (host, f32) and
    the first routing call's expert ids."""
    eng = ServeEngine(model, params, page_size=16, num_pages=2048,
                      max_pages_per_seq=128, prefix_cache=True,
                      device="cuda:0", **engine)
    prompts = cs.dense_prompts(model.cfg, cs.FAMILY_PROMPTS,
                               np.random.default_rng(seed))
    with cs.routed_experts(limit=1) as ids, \
            cs.pass_logits("_fused_decode_step", limit=1) as seen:
        roots = [eng.add_request(p) for p in prompts]
        eng.decode([k for r in roots for k in eng.fork(r, 4)])
    for r in roots:
        eng.release(r)
    return seen[0], ids[0]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    print(cs.card_line(), torch.__version__, flush=True)
    _build.build_all()
    cfg = dataclasses.replace(get_config("dbrx-132b"),
                              num_layers=args.layers)
    model = Model(cfg)
    plan = serving_plan(serving_mesh(4, ["cuda:0"] * 4))
    wide = L.partial_product
    out = []
    for seed in args.seeds:
        whole = model.init(torch.Generator(device="cuda").manual_seed(seed))
        shards = model.init(torch.Generator(device="cuda").manual_seed(seed),
                            shards=plan)
        for name, product in (("f32", wide),
                              ("bf16", lambda x, w, shards: x @ w)):
            L.partial_product = product
            try:
                one, ids1 = first_step(model, whole, seed)
                four, ids4 = first_step(model, shards, seed, tp=4)
            finally:
                L.partial_product = wide
            rows = ((four - one).square().mean(-1).sqrt()
                    / one.square().mean(-1).sqrt()).flatten()
            rec = {"seed": seed, "partials": name,
                   "first_call_rows_as_tp1": round(sum(
                       a == b for a, b in zip(ids4, ids1)) / len(ids1), 4),
                   "first_step_rel_rms": round(cs.rel_rms(four, one), 4),
                   "by_row": [round(x, 4) for x in rows.tolist()]}
            print(json.dumps(rec), flush=True)
            out.append(rec)
        del whole, shards
        torch.cuda.empty_cache()
    print(json.dumps({"layers": args.layers, "runs": out}))


if __name__ == "__main__":
    main()
