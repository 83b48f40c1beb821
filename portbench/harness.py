"""One run of one cell: set-up, a timed window, an optional traced segment,
the comparison with the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by name: ``BENCHMARK.json`` names the cell's configuration file
and its traffic mix, ``workloads/<traffic>.json`` names the driver (a
module of ``drivers/``) that generates that traffic, ``metrics/<name>.py``
reads one metric (or ``metrics/<quantity>.py``, the name up to its first
dot, for a quantity split by cell), ``kernels/<family>/*.json`` list the kernel names that a
family's roofline reads.
"""

from __future__ import annotations

import gc
import glob
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diffbinaural_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN`` (``diffbinaural_tpu_torch`` is not ``diffbinaural_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def assert_no_forbidden(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise BenchError(f"forbidden modules loaded {when}: {found}")


def load_manifest(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise BenchError(f"no BENCHMARK.json in {root}")
    with open(path) as f:
        return json.load(f)


def read_json(path: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, path)) as f:
        return json.load(f)


def cell_spec(manifest: dict, workload: str, root: str = ROOT) -> tuple:
    """(cell, configuration entry, configuration, traffic) of a cell."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    entry = configs[cell["config"]]
    traffic = read_json(os.path.join("portbench", "workloads",
                                     cell["traffic"] + ".json"), root)
    return cell, entry, read_json(entry["file"], root), traffic


def applies(metric: dict, cell: str, manifest: dict) -> bool:
    """Whether a metric is reported in ``cell``: listed there, or, without
    a list, in every cell that reports the end-to-end metric it moves (an
    end-to-end metric without a list is reported everywhere)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        e2e = {m["name"]: m for m in manifest["end_to_end"]}
        return applies(e2e[metric["moves"]], cell, manifest)
    return True


def reader_path(name: str, here: str = HERE) -> str:
    """``metrics/<name>.py``, or else the reader of the quantity the name
    splits by cell: ``metrics/<name up to its first dot>.py``."""
    path = os.path.join(here, "metrics", name + ".py")
    if os.path.exists(path):
        return path
    return os.path.join(here, "metrics", name.split(".")[0] + ".py")


def load_reader(name: str):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kernel_names(family: str) -> list:
    names = []
    for path in sorted(glob.glob(os.path.join(HERE, "kernels", family,
                                              "*.json"))):
        with open(path) as f:
            names += json.load(f)["kernels"]
    return names


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Run:
    """What the metric readers see of one run."""

    def __init__(self, cell, config, traffic, seed, seconds, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.device = seed, seconds, device
        self.setup_s = None
        self.window_s = None
        self.requests = []          # dicts of the window's requests
        self.segment = []           # dicts of the traced segment's requests
        self.window_counters = {}
        self.segment_counters = {}
        self.segment_work = {}
        self.window_peak_bytes = 0
        self.limits = {}            # compared number -> its limit
        self.trace = None
        self.kernel_names = kernel_names


def _timed_request(driver, spans, sink, failures):
    with spans.span("request") as info:
        try:
            info.update(driver.request())
        except Exception:                    # noqa: BLE001 - counted, shown
            traceback.print_exc()
            failures.append(len(sink))
            info["failed"] = True
    start, end, _ = spans.records["request"][-1]
    sink.append(dict(info, latency_s=end - start, start=start, end=end))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None,
             manifest: dict = None, root: str = ROOT) -> dict:
    """One run; returns the result object (the last line's fields, with the
    compared numbers under ``checks``).  ``root`` holds ``BENCHMARK.json``
    and the cell's data files."""
    import torch

    from .tracing import DeviceTrace, Spans

    t_start = time.perf_counter() if t_start is None else t_start
    manifest = manifest or load_manifest(root)
    cell, _, config, traffic = cell_spec(manifest, workload, root)
    run = Run(cell, config, traffic, seed, seconds, device)
    run.limits = read_json(os.path.join("portbench", "limits",
                                        workload + ".json"), root)
    cuda = device.startswith("cuda")
    if cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    spans = Spans()
    module = importlib.import_module("portbench.drivers." + traffic["driver"])
    driver = module.Driver(config, traffic, seed, device, spans)
    driver.setup()
    assert_no_forbidden("after set-up")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    run.setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = dict(spans.counters)
    failures = []
    t0 = time.perf_counter()
    end = t0 + seconds
    # a driver whose traffic comes in cycles ends the window on a whole one
    at_boundary = getattr(driver, "at_boundary", lambda: True)
    while True:
        _timed_request(driver, spans, run.requests, failures)
        if time.perf_counter() >= end and at_boundary():
            break
    sync()
    run.window_s = time.perf_counter() - t0
    run.window_counters = {k: v - before.get(k, 0)
                           for k, v in spans.counters.items()}
    assert_no_forbidden("after the window")
    run.window_peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    peak = max(setup_peak, run.window_peak_bytes)

    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        before = dict(spans.counters)
        spans.annotate = True
        spans.work.clear()
        with profile(activities=activities) as prof:
            t1 = time.perf_counter()
            for _ in range(traffic["trace_requests"]):
                _timed_request(driver, spans, run.segment, failures)
            sync()
            seg_s = time.perf_counter() - t1
        spans.annotate = False
        run.segment_counters = {k: v - before.get(k, 0)
                                for k, v in spans.counters.items()}
        run.segment_work = {k: list(v) for k, v in spans.work.items()}
        run.trace = DeviceTrace(prof, seg_s)
        del prof
        if cuda:
            peak = max(peak, torch.cuda.max_memory_allocated())

    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(run)
    assert_no_forbidden("at the end")

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest[kind]:
        if not applies(m, workload, manifest):
            continue
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = not failures and all(
        c["value"] == c["value"] and c["value"] <= c["limit"]
        for c in checks.values())
    result = {
        "correct": bool(correct),
        "attempted": len(run.requests) + len(run.segment),
        "failed": len(failures),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result
