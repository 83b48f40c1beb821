"""Readings from which the limits of ``correct`` are set, on the card:

    python -m portbench.control --workload <cell> --program-seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 4] [--trace-every 4]

For each program seed, one whole run of the cell in this process (every
``--trace-every``-th traced), its compared numbers.  For each control seed,
the same numbers with the plain reference put in the program's place and
computed in TF32, the step below float32 on this card; for a training
cell also with half of every batch left out (the mean over the rest).
One JSON object per reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import torch

from portbench import harness
from portbench.drivers.common import rel_gap
from portbench.tracing import Spans


def _driver(workload: str, seed: int, device: str, root: str):
    manifest = harness.load_manifest(root)
    cell, _, config, traffic = harness.cell_spec(manifest, workload, root)
    module = __import__("portbench.drivers." + traffic["driver"],
                        fromlist=["Driver"])
    limits = harness.read_json(f"portbench/limits/{workload}.json", root)
    return module, module.Driver(config, traffic, seed, device, Spans()), \
        limits


def control_readings(workload: str, seed: int, device: str = "cuda",
                     root: str = harness.ROOT) -> list:
    """[(kind, checks)] of the lower-precision control and, for training,
    of the half-batch fault."""
    module, drv, limits = _driver(workload, seed, device, root)
    if hasattr(module, "compare"):
        ref = drv.reference()
        half = slice(0, drv.traffic["batch"] // 2)
        return [("control_tf32", module.compare(drv.reference(tf32=True), ref,
                                                limits)),
                ("fault_half_batch", module.compare(drv.reference(rows=half),
                                                    ref, limits))]
    n = drv.traffic["check_requests"]
    if hasattr(drv, "follow"):
        gaps = drv.follow([drv.serve_reference(k, tf32=True)
                           for k in range(n)])
        return [("control_tf32", {k: {"value": v, "limit": limits[k]}
                                  for k, v in gaps.items()})]
    if hasattr(drv, "lengths"):
        items = list(range(len(drv.lengths)))[: n - 1] + [
            int(drv.lengths.argmax())]
    else:
        items = list(range(n))
    want, got = drv.reference(items), drv.reference(items, tf32=True)
    gap = max(rel_gap(g, w) for g, w in zip(got, want))
    return [("control_tf32", {"wave_gap": {"value": gap,
                                           "limit": limits["wave_gap"]}})]


def look(drv, prog: dict, ref: dict) -> dict:
    """Where a training cell's gaps sit: per group, the five leaves with the
    widest change and first-gradient gaps (size, the reference's first
    gradient and change over their medians), and the median leaf's gaps."""
    import statistics

    from portbench.drivers import train_gan

    with torch.device("meta"):
        sizes = {k: {n: p.numel() for n, p in ps.items()}
                 for k, ps in train_gan._groups(*drv._ref_modules()).items()}
    out = {}
    for k in train_gan.GROUPS:
        first, change = ref["first"][k], ref["change"][k]
        mf, mc = (statistics.median(first.values()),
                  statistics.median(change.values()))
        rows = []
        for n in first:
            rows.append({
                "leaf": n, "size": sizes[k][n], "first_over_median":
                first[n] / mf, "change_over_median": change[n] / mc,
                "grad_gap": abs(prog["first"][k][n] - first[n])
                / max(first[n], mf),
                "change_gap": abs(prog["change"][k][n] - change[n])
                / max(change[n], mc)})
        moved = [r for r in rows if r["first_over_median"] >= 1e-3]
        out[k] = {
            "worst_change": sorted(moved, key=lambda r: -r["change_gap"])[:5],
            "worst_grad": sorted(rows, key=lambda r: -r["grad_gap"])[:5],
            "median_leaf_change_gap": statistics.median(
                r["change_gap"] for r in moved),
            "median_leaf_grad_gap": statistics.median(
                r["grad_gap"] for r in rows)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--trace-every", type=int, default=4)
    p.add_argument("--look-seeds", default="",
                   help="training cells: where the gaps sit, program and "
                        "control, without a window")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.program_seeds.split(",") if s]
    for i, seed in enumerate(seeds):
        trace = args.trace_every > 0 and i % args.trace_every == (
            args.trace_every - 1)
        try:
            r = harness.run_cell(args.workload, seed, args.seconds, trace)
        except Exception:                     # noqa: BLE001 - shown, go on
            traceback.print_exc()
            continue
        print(json.dumps({"kind": "program", "seed": seed, "trace": trace,
                          "correct": r["correct"], "checks": r["checks"],
                          "metrics": r["metrics"]}), flush=True)
    for seed in (int(s) for s in args.look_seeds.split(",") if s):
        module, drv, limits = _driver(args.workload, seed, "cuda",
                                      harness.ROOT)
        drv.setup()
        prog = drv.program
        drv.release()
        torch.cuda.empty_cache()
        ref = drv.reference()
        for kind, got in (("program", prog),
                          ("control_tf32", drv.reference(tf32=True))):
            print(json.dumps({"kind": "look_" + kind, "seed": seed,
                              "readings": module.readings(got, ref),
                              "look": look(drv, got, ref)}), flush=True)
        torch.cuda.empty_cache()
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        for kind, checks in control_readings(args.workload, seed):
            print(json.dumps({"kind": kind, "seed": seed, "checks": checks}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
