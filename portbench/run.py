"""Run one cell of the port's benchmark on the card.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the checks' numbers beside their limits as the last lines of
standard error, and the result as one JSON object on the last line of
standard output.  Exits non-zero, printing no result, without a CUDA card
(or with fewer than the cell needs), when a forbidden module is loaded, or
when the run cannot finish.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402

CACHE = os.path.join(harness.ROOT, ".portbench_cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache of a build or compiler at a fixed path in the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    # one host thread: the card does the work, and idle intra-op threads
    # spinning beside the launching thread only add noise to its timing
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)

    try:
        manifest = harness.load_manifest()
        cell, _, _, _ = harness.cell_spec(manifest, args.workload)
        if not torch.cuda.is_available():
            raise harness.BenchError("no CUDA card")
        if torch.cuda.device_count() < cell["chips"]:
            raise harness.BenchError(
                f"{args.workload} needs {cell['chips']} cards, "
                f"{torch.cuda.device_count()} present")
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda", T_START, manifest)
    except harness.BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    print(f"portbench: card {harness.power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
