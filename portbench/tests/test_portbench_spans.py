"""The program-span helper (``program_spans.py``) and its readers on a
hand-built trace: launches go to the chain of spans open at their launch
time, idle time to the innermost span open at each instant."""

from types import SimpleNamespace

import pytest

from portbench import harness, program_spans

P = program_spans.PREFIX
# host ranges (start, end, name): a clip with one sampler step around one
# UNet call, and a host op that is not a program span
HOST = [(0, 100, P + "pipeline"), (10, 50, P + "sampler.step"),
        (20, 40, P + "unet"), (22, 24, "aten::add"),
        (60, 70, P + "pipeline.stitch"), (90, 95, "portbench.unet")]
# device activities (start, end, name, launch time)
KERNELS = [(5, 8, "windows", 5), (15, 30, "time_cond", 15),
           (30, 45, "conv", 25), (60, 62, "stitch_add", 65),
           (70, 80, "glue", 80), (100, 110, "late", 105),
           (110, 120, "no_launch_time", None)]


class _Trace:
    """What the helper reads of a ``DeviceTrace``."""

    def __init__(self, host, kernels):
        self._host_ops, self.kernels = list(host), sorted(
            kernels, key=lambda k: k[:3])


def _trace(host=HOST, kernels=KERNELS):
    return _Trace(host, kernels)


def _run(trace):
    return SimpleNamespace(trace=trace)


def test_launches_go_to_the_spans_open_at_launch():
    spans = program_spans.ProgramSpans(_trace())
    assert spans.counts == {"pipeline": 1, "sampler.step": 1, "unet": 1,
                            "pipeline.stitch": 1}
    assert spans.chain(25) == ("pipeline", "sampler.step", "unet")
    assert spans.chain(15) == ("pipeline", "sampler.step")
    assert spans.chain(100) == spans.chain(-1) == spans.chain(None) == ()

    def names(*args):
        return [k[2] for k in spans.launched(*args)]

    assert names("unet") == ["conv"]
    assert names("sampler.step") == ["time_cond", "conv"]
    assert names("sampler.step", ("unet",)) == ["time_cond"]
    assert names("pipeline", ("sampler.step",)) == ["windows", "stitch_add",
                                                     "glue"]
    assert names("pipeline.stitch") == ["stitch_add"]
    assert spans.device_ms("sampler.step") == pytest.approx(30 / 1e6)


def test_an_activity_without_a_launch_time_is_left_unattributed():
    spans = program_spans.ProgramSpans(_trace())
    everywhere = {k[2] for name in spans.counts
                  for k in spans.launched(name)}
    assert "no_launch_time" not in everywhere and "late" not in everywhere
    assert len(everywhere) == 5


def test_idle_is_split_by_the_innermost_span_at_each_instant():
    # busy: [5, 8], [15, 45], [60, 62], [70, 80] (and after the spans)
    idle = program_spans.ProgramSpans(_trace()).idle_ms_by_innermost()
    ns = {k: round(v * 1e6) for k, v in idle.items()}
    # pipeline innermost over [0, 10], [50, 60], [70, 100]: idle 0-5, 8-10,
    # 50-60, 80-100; sampler.step over [10, 20], [40, 50]: idle 10-15, 45-50
    assert ns == {"pipeline": 5 + 2 + 10 + 20, "sampler.step": 5 + 5,
                  "unet": 0, "pipeline.stitch": 8}


def test_readers_on_the_hand_built_clip():
    run = _run(_trace())

    def read(name):
        return harness.load_reader(name)(run)

    assert read("unet_launches_per_call") == 1
    assert read("sampler_launches_per_step") == 1
    assert read("pipeline_launches_per_clip") == 3
    assert read("unet_idle_ms_per_call") == 0
    assert read("vocoder_io_idle_ms_per_request") is None
    assert read("d_phase_device_ms") is None


@pytest.mark.parametrize("trace", [
    None,                                               # untraced run
    _trace(kernels=[]),                                 # a CPU run
    _trace(host=[h for h in HOST if not h[2].startswith(P)]),  # no spans
])
def test_nothing_to_read_gives_none(trace):
    assert program_spans.read(_run(trace)) is None
    for m in harness.load_manifest()["per_layer"]:
        if m["source"] == "program_span":
            assert harness.load_reader(m["name"])(_run(trace)) is None

