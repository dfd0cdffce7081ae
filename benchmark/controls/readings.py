#!/usr/bin/env python3
"""The readings that each cell's limits are set from, on the card at the
cell's own size, many seeds in one process:

    python3 benchmark/controls/readings.py --workload <cell> \
        --seeds 11,12,13 --side program|control [--seconds 3] [--out FILE]
        [--fault unchanged|half_batch|altered] [--sim_dtype bfloat16]

program  the program's set-up and check steps (training) or a short window
         of requests (search), judged by the float32 reference: the lower
         readings, those of sound runs (with --fault, the readings of a
         fault planted under the program: kinds/train.py, kinds/search.py);
control  the reference itself in the program's place, its towers one
         precision below the configuration's (float8 operands for
         bfloat16), judged the same way: the upper readings.

--sim_dtype bfloat16 (program side) is the second control: the program
with its own bfloat16 similarity switched on, one step below the float32
the configuration states for it (training: the configuration's
`sim_dtype`; search, whose Searcher multiplies in float32 whatever
`sim_dtype` says: its similarity call made with sim_dtype="bfloat16",
which sends K2 to its bf16 entry).

Each seed prints one JSON line {"seed", "side", <numbers>}.  The limit of
a number lies above the largest program reading and below the smallest
control reading (benchmark/limits/<cell>.json).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmark.harness import compare, core, port  # noqa: E402
from benchmark.kinds import search as KS  # noqa: E402
from benchmark.kinds import train as KT  # noqa: E402

CONTROL = "float8"      # one precision below the towers' bfloat16


def program(files, seed, seconds, device, fault=None, sim_dtype=None):
    driver = KT if files["traffic"]["driver"] == "train" else KS
    with similarity_in(files, sim_dtype):
        out = driver.run(files, seed, seconds, False, device, time.time(),
                         fault, log=lambda m: None)
    nums = {k: c["value"] for k, c in out["checks"].items()}
    nums.update(out.get("info", {}))
    return nums


@contextlib.contextmanager
def similarity_in(files, sim_dtype):
    """The program's similarity in `sim_dtype` (None: as configured)."""
    if sim_dtype is None:
        yield
        return
    if files["traffic"]["driver"] == "train":
        model = files["config"]["model"]
        old = model["sim_dtype"]
        model["sim_dtype"] = sim_dtype
        try:
            yield
        finally:
            model["sim_dtype"] = old
        return
    from neighborretr_tpu_torch.train import evaluate
    orig = evaluate.local_similarity

    def lowered(*args, **kwargs):
        kwargs["sim_dtype"] = sim_dtype
        return orig(*args, **kwargs)

    evaluate.local_similarity = lowered
    try:
        yield
    finally:
        evaluate.local_similarity = orig


def control(files, seed, device):
    rcfg = port.reference_cfg(files)
    shapes = _shapes(files)
    if files["traffic"]["driver"] == "train":
        low = KT.reference_readings(files, rcfg, shapes, seed, device,
                                    CONTROL)
        ref = KT.reference_readings(files, rcfg, shapes, seed, device,
                                    "float32")
        return compare.train_numbers(low, ref)
    return search_control(files, rcfg, shapes, seed, device)


def _shapes(files):
    from neighborretr_tpu_torch.models.neighborretr import NeighborRetr
    cfg = port.program_config(files)
    return port.shapes(NeighborRetr(cfg.model, device="meta"))


def search_control(files, rcfg, shapes, seed, device):
    """The lower-precision reference answers the judged queries (its own top
    k over the whole index); the float32 reference judges them."""
    from benchmark.reference import search as RS
    from benchmark.reference.precision import Precision, set_float32_exact
    from benchmark.reference.tokenizer import Tokenizer
    set_float32_exact()
    t = files["traffic"]
    gen = core.generator(files)
    queries = gen.make_queries(t, seed)
    n = t["judge"] + t["judge_longest"]
    by_len = sorted(range(len(queries)), key=lambda i: -len(queries[i].split()))
    qs = [queries[i] for i in by_len[:t["judge_longest"]]] + \
        queries[:n - t["judge_longest"]]
    P = port.reference_weights(shapes, seed, device)
    feat, mask = gen.make_index(t, rcfg["model"]["embed_dim"], seed, device)
    feat = feat.float()
    tok = Tokenizer()
    worst = {"score_gap": 0.0, "rank_gap": 0.0}
    with torch.no_grad():
        for s in range(0, len(qs), 64):
            tl, ml = RS.query_features(P, tok, qs[s:s + 64], rcfg["model"],
                                       Precision(CONTROL))
            low = RS.scores(P, tl, ml, feat, mask)
            vals, ids = torch.topk(low, t["topk"], dim=1)
            tf, mf = RS.query_features(P, tok, qs[s:s + 64], rcfg["model"],
                                       Precision("float32"))
            ref = RS.scores(P, tf, mf, feat, mask)
            top = torch.topk(ref, t["topk"], dim=1).values
            nums = compare.search_numbers(ids.cpu().numpy(),
                                          vals.cpu().numpy(), ref, top)
            for k in worst:
                worst[k] = max(worst[k], nums[k])
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--side", choices=("program", "control"), required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--fault", default=None,
                   help="a fault planted under the program (program side)")
    p.add_argument("--sim_dtype", default=None, choices=("bfloat16",),
                   help="the program's own lower-precision similarity "
                   "(program side)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    core.cache_dirs()
    core.require_cards(1)
    files = core.cell_files(core.manifest(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        if args.side == "program":
            nums = program(files, seed, args.seconds, "cuda", args.fault,
                           args.sim_dtype)
        else:
            nums = control(files, seed, "cuda")
        rec = dict(seed=seed, side=args.side, fault=args.fault,
                   sim_dtype=args.sim_dtype,
                   s=round(time.time() - t0, 1), **nums)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    core.check_guard()
    return 0


if __name__ == "__main__":
    sys.exit(main())
