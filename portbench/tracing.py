"""Spans, counters and the device trace of one run.

Spans are host-clock intervals the harness opens around calls into the
port (``Spans.span``), and in a traced segment also ``torch.profiler``
ranges named ``portbench.<span>``; counters are plain integers bumped by
forward hooks the drivers register on the port's modules.  Nothing is
placed inside the port.

``DeviceTrace`` reads the profiler's raw events (no per-op aggregation,
which takes minutes on a whole clip): every device activity that is not an
annotation, the host time of its launch (the runtime call that shares its
correlation id), and the ``portbench.*`` host ranges.  From those: the busy seconds
(the union of device intervals), device seconds by kernel name, device
seconds launched inside each named range, and the longest idle gaps with
the innermost host op that was running at each.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict

import torch

PREFIX = "portbench."
# host events of the CUDA runtime and driver APIs (cudaLaunchKernel,
# cuLaunchKernelEx, cudaMemcpyAsync, ...): their correlation id is the one
# CUPTI gives the device activity they start
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


class Spans:
    """Host-clock spans and counters of one run."""

    def __init__(self):
        self.records = defaultdict(list)   # name -> [(start, end, info)]
        self.counters = defaultdict(int)
        self.work = defaultdict(list)      # family -> [(flops, bytes)]
        self.annotate = False              # profiler ranges on, work kept

    @contextlib.contextmanager
    def span(self, name: str, **info):
        rf = None
        if self.annotate:
            rf = torch.autograd.profiler.record_function(PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield info
        finally:
            self.records[name].append((t0, time.perf_counter(), info))
            if rf is not None:
                rf.__exit__(None, None, None)

    def hook_module(self, module, name: str):
        """Count ``module``'s forward calls under ``name`` and, while
        ``annotate`` is on, mark each as a profiler range."""
        stack = []

        def pre(mod, args):
            self.counters[name] += 1
            if self.annotate:
                rf = torch.autograd.profiler.record_function(PREFIX + name)
                rf.__enter__()
                stack.append(rf)

        def post(mod, args, out):
            if stack:
                stack.pop().__exit__(None, None, None)

        return [module.register_forward_pre_hook(pre),
                module.register_forward_hook(post)]


class DeviceTrace:
    """What one ``torch.profiler`` segment shows of the device."""

    def __init__(self, prof, window_s: float):
        self.window_s = window_s
        events = prof.profiler.kineto_results.events()
        launch, host_start = {}, {}
        ranges = defaultdict(list)
        host_ops = []
        self.kernels = []                  # (start_ns, end_ns, name, launch)
        device = []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CPU:
                end = e.start_ns() + e.duration_ns()
                if RUNTIME.match(e.name()):
                    launch[e.correlation_id()] = e.start_ns()
                else:
                    host_start[e.correlation_id()] = e.start_ns()
                if e.name().startswith(PREFIX) and e.is_user_annotation():
                    ranges[e.name()[len(PREFIX):]].append((e.start_ns(), end))
                host_ops.append((e.start_ns(), end, e.name()))
            elif (not e.is_user_annotation() and e.duration_ns() > 0
                  and not e.name().startswith(PREFIX)):
                device.append(e)
        for e in device:
            t = launch.get(e.correlation_id(),
                           host_start.get(e.linked_correlation_id()))
            self.kernels.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                 e.name(), t))
        self.kernels.sort()
        self.ranges = {k: sorted(v) for k, v in ranges.items()}
        self._host_ops = host_ops
        self.busy_s = self._busy() / 1e9

    def _busy(self) -> int:
        busy, cur_s, cur_e = 0, None, None
        for s, e, _, _ in self.kernels:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def seconds_by_kernel(self) -> dict:
        out = defaultdict(float)
        for s, e, name, _ in self.kernels:
            out[name] += (e - s) / 1e9
        return dict(out)

    def seconds_matching(self, names) -> float:
        """Device seconds of kernels whose name holds any of ``names`` as
        an identifier (``flash_d32_f32_kernel`` in ``void
        flash_d32_f32_kernel<...>(...)``)."""
        total = 0.0
        for kernel, sec in self.seconds_by_kernel().items():
            ident = kernel.replace("(", " ").replace("<", " ").split()
            if any(n in ident for n in names):
                total += sec
        return total

    def seconds_inside(self, span: str) -> float:
        """Device seconds of the activities launched from inside the
        ``portbench.<span>`` host ranges."""
        spans = self.ranges.get(span, [])
        starts = [s for s, _ in spans]
        total = 0
        for s, e, _, t in self.kernels:
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += e - s
        return total / 1e9

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.seconds_by_kernel().items(), key=lambda kv: -kv[1])
        gaps, last = [], None
        for s, e, _, _ in self.kernels:
            if last is not None and s > last:
                gaps.append((s - last, last, s))
            last = e if last is None else max(last, e)
        gaps.sort(reverse=True)
        idle = []
        for length, a, b in gaps[:top]:
            mid = (a + b) // 2
            inner = [(oe - os_, name) for os_, oe, name in self._host_ops
                     if os_ <= mid <= oe]
            idle.append([min(inner)[1] if inner else "(no host op)",
                         length / 1e9])
        return {"device_ops": [[k[:160], v] for k, v in ops[:top]],
                "idle_gaps": idle}
