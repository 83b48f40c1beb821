"""The program's own spans in a traced segment.

The port opens a ``torch.profiler`` range named ``diffbinaural.<span>`` at
each of its layer boundaries (``utils/profiling.py:span``).  The profiler
stamps those host ranges on the clock it maps the device's activities onto,
so the ``DeviceTrace`` the harness builds already holds them among its host
ops, beside every device activity with the host time of its launch.

Ranges nest in time on the calling thread.  A device activity belongs to
the chain of spans open at its launch time (an activity without a launch
time belongs to none); the device's idle time is split, instant by instant,
to the innermost span open on the host.  A trace of a program that opens no
spans reads as empty: every count is 0 and every reader returns None.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

PREFIX = "diffbinaural."


class ProgramSpans:
    """The ``diffbinaural.*`` ranges of one ``DeviceTrace``."""

    def __init__(self, trace):
        ranges = sorted((s, -e, name[len(PREFIX):])
                        for s, e, name in trace._host_ops
                        if name.startswith(PREFIX))
        self.ranges = [(s, -neg_e, name) for s, neg_e, name in ranges]
        self.counts = Counter(name for _, _, name in self.ranges)
        self.kernels = trace.kernels
        # the timeline cut at every range's start and end; each piece holds
        # the chain of ranges open over it, outermost first
        self._cuts = sorted({t for s, e, _ in self.ranges for t in (s, e)})
        self._chains = [
            tuple(name for s, e, name in self.ranges if s <= a and b <= e)
            for a, b in zip(self._cuts, self._cuts[1:])]
        self._launch_chains = [self.chain(k[3]) for k in self.kernels]

    def chain(self, t) -> tuple:
        """The spans open at host time ``t``, outermost first."""
        if t is None:
            return ()
        i = bisect.bisect_right(self._cuts, t) - 1
        return self._chains[i] if 0 <= i < len(self._chains) else ()

    def launched(self, within: str, without=()) -> list:
        """Device activities (start, end, name, launch) launched inside a
        ``within`` span and inside none of ``without``."""
        return [k for k, names in zip(self.kernels, self._launch_chains)
                if within in names and not set(without) & set(names)]

    def device_ms(self, within: str) -> float:
        """Device ms of the activities launched inside a ``within`` span."""
        return sum(e - s for s, e, _, _ in self.launched(within)) / 1e6

    def idle_ms_by_innermost(self) -> dict:
        """Device idle ms over the spans' extent, by the innermost span open
        on the host at each instant."""
        busy = []                           # merged device intervals
        for s, e, _, _ in self.kernels:
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e])
        starts = [s for s, _ in busy]
        before = [0]                        # busy ns before each interval
        for s, e in busy:
            before.append(before[-1] + e - s)

        def busy_until(t):
            i = bisect.bisect_right(starts, t) - 1
            if i < 0:
                return 0
            return before[i] + min(t, busy[i][1]) - busy[i][0]

        out = defaultdict(float)
        for a, b, names in zip(self._cuts, self._cuts[1:], self._chains):
            if names:
                idle = (b - a) - (busy_until(b) - busy_until(a))
                out[names[-1]] += idle / 1e6
        return dict(out)


def read(run):
    """The run's program spans, or None when the segment holds no device
    activity or no span (an untraced run, a CPU run, a program without
    spans)."""
    if run.trace is None or not run.trace.kernels:
        return None
    spans = ProgramSpans(run.trace)
    return spans if spans.ranges else None
