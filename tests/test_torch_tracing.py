"""The port's spans (``utils/profiling.py:span``) on the CPU at tiny sizes:
off, a span is one shared no-op; under ``torch.profiler`` each layer's span
appears where its work happens, nested as the layers call each other, and
changes neither a result nor a kernel wrapper's launch count."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffbinaural_tpu_torch import ops
from diffbinaural_tpu_torch.core.config import VocoderConfig
from diffbinaural_tpu_torch.diffusion import GaussianDiffusion
from diffbinaural_tpu_torch.infer import BinauralPipeline, Vocoder
from diffbinaural_tpu_torch.losses import MultiScaleMelSpectrogramLoss
from diffbinaural_tpu_torch.models import (bigvgan, discriminators,
                                           init_parameters, unet)
from diffbinaural_tpu_torch.signal import mel_spectrogram
from diffbinaural_tpu_torch.train import make_stage2_train_step
from diffbinaural_tpu_torch.utils import profiling

M, WINDOW, STRIDE, FRAMES, GROUP, STEPS = 16, 16, 8, 40, 3, 3
VOC = dict(num_mels=M, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
           upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
           resblock_dilation_sizes=((1, 3), (1, 3)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spans(fn):
    """``fn()``'s result and its program spans [(name, start, end)] in
    start order (the enclosing span first on a tie)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name()[len(profiling.PREFIX):], e.start_ns(),
              e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(profiling.PREFIX)]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _names(spans):
    return [name for name, _, _ in spans]


def _pipeline(sampler="ddim"):
    net = init_parameters(unet.AudioVisualModel(dim=16), 0).eval()
    with torch.no_grad():
        net.net_unet.final_conv.weight.mul_(0.01)
    voc = init_parameters(bigvgan.BigVGAN(VocoderConfig(**VOC)), 1).eval()
    pipe = BinauralPipeline(net, voc, FRAMES, num_mels=M, window=WINDOW,
                            stride=STRIDE, crop_frames=2, unet_batch=GROUP,
                            sampling_timesteps=STEPS, sampler=sampler,
                            device="cpu")
    rng = np.random.default_rng(1)
    mono = (rng.standard_normal((1, M, FRAMES)) - 5.0).astype(np.float32)
    feats = rng.standard_normal((pipe.n_windows, 512)).astype(np.float32)
    return pipe, mono, feats


def test_span_off_is_one_shared_no_op(monkeypatch):
    """Off, ``span`` checks the profiler's state and hands back the same
    context every time: no profiler range, no synchronisation, no clock."""
    def refuse(*args, **kwargs):
        raise AssertionError("called with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("unet")
    assert first is profiling.span("sampler.step") is profiling._OFF
    with first as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith(profiling.PREFIX)]


def test_span_on_is_a_named_profiler_range():
    def work():
        with profiling.span("outer"):
            with profiling.span("inner"):
                return torch.ones(8, 8) @ torch.ones(8, 8)

    out, spans = _spans(work)
    assert torch.equal(out, torch.full((8, 8), 8.0))
    assert _names(spans) == ["outer", "inner"]
    assert _inside(spans[1], spans[0])
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("after") is profiling._OFF


@pytest.mark.parametrize("sampler", ["ddim", "dpm++"])
def test_clip_spans_nest_as_the_layers_call(sampler):
    pipe, mono, feats = _pipeline(sampler)
    wav, spans = _spans(lambda: pipe(mono, feats))
    assert wav.shape == (2, FRAMES * 8) and torch.isfinite(wav).all()
    names = _names(spans)
    calls = pipe.n_batches * STEPS
    assert (pipe.n_windows, pipe.n_batches) == (4, 2)
    assert names.count("unet") == names.count("sampler.step") == calls
    for name in ("pipeline", "pipeline.windows", "pipeline.stitch",
                 "generator"):
        assert names.count(name) == 1, name
    top = spans[0]
    assert top[0] == "pipeline"
    assert all(_inside(s, top) for s in spans)
    steps = [s for s in spans if s[0] == "sampler.step"]
    for u in (s for s in spans if s[0] == "unet"):
        assert sum(_inside(u, s) for s in steps) == 1
    # windows, then every step, then the stitch, then the generator
    order = [n for n in names if n != "unet"]
    assert order == (["pipeline", "pipeline.windows"]
                     + ["sampler.step"] * calls
                     + ["pipeline.stitch", "generator"])


def test_ancestral_sampler_spans_each_step():
    diffusion = GaussianDiffusion(image_size=4, timesteps=5,
                                  sampling_timesteps=5, auto_normalize=False,
                                  device="cpu")

    def model_fn(x, t, condition):
        with profiling.span("unet"):
            return 0.5 * x

    _, spans = _spans(lambda: diffusion.p_sample_loop(
        model_fn, None, (1, 2, 4, 4),
        generator=torch.Generator().manual_seed(0)))
    steps = [s for s in spans if s[0] == "sampler.step"]
    assert len(steps) == 5 and _names(spans).count("unet") == 5
    for u in (s for s in spans if s[0] == "unet"):
        assert sum(_inside(u, s) for s in steps) == 1


def test_vocoder_request_spans_in_order():
    gen = init_parameters(bigvgan.BigVGAN(VocoderConfig(**VOC)), 1).eval()
    voc = Vocoder(config=VocoderConfig(**VOC), hop_size=8, pad_multiple=8,
                  model=gen, device="cpu")
    mel = np.random.default_rng(2).standard_normal((1, M, 13)).astype(
        np.float32) - 5.0
    wav, spans = _spans(lambda: voc(mel))
    assert wav.shape == (1, 13 * 8) and np.isfinite(wav).all()
    assert _names(spans) == ["vocoder", "vocoder.pad", "vocoder.to_device",
                             "generator", "vocoder.to_host"]
    assert all(_inside(s, spans[0]) for s in spans[1:])
    for a, b in zip(spans[1:], spans[2:]):
        assert a[2] <= b[1], (a[0], b[0])


@torch.no_grad()
def _filled(module, seed):
    """Every leaf drawn from ``seed``: kernels N(0, 1/fan_in), gains
    1 + N(0, 0.1^2), the rest N(0, 0.1^2)."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        z = torch.randn(p.shape, generator=gen)
        if p.dim() > 1:
            p.copy_(z / p[0].numel() ** 0.5)
        else:
            p.copy_(0.1 * z + float(name.endswith("g")))
    return module


def _stage2(freeze_step):
    gen = init_parameters(bigvgan.BigVGAN(VocoderConfig(**VOC)), 1)
    mpd = _filled(discriminators.MultiPeriodDiscriminator(
        periods=(2, 3), channel_mult=0.125), 2)
    mrd = _filled(discriminators.MultiScaleSubbandCQTDiscriminator(
        sampling_rate=22050, hop_lengths=(256,), n_octaves=(9,),
        bins_per_octaves=(2,), filters=8), 3)
    init_fn, step_fn = make_stage2_train_step(
        gen, mpd, mrd, lambda w: mel_spectrogram(w, 32, M, 22050, 8, 32),
        MultiScaleMelSpectrogramLoss(22050, n_mels=(5, 10),
                                     window_lengths=(32, 64)),
        learning_rate=5e-5, freeze_step=freeze_step, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"mel": rng.standard_normal((2, M, 32)).astype(np.float32) - 1,
             "audio": 0.3 * rng.standard_normal((2, 256)).astype(np.float32)}
    return init_fn(), step_fn, batch


@pytest.mark.parametrize("frozen", [False, True])
def test_stage2_step_spans_its_phases(frozen):
    state, step_fn, batch = _stage2(freeze_step=1 if frozen else 0)
    (state, metrics), spans = _spans(lambda: step_fn(state, batch))
    assert state.step == 1 and np.isfinite(float(metrics["loss_gen_all"]))
    names = _names(spans)
    phases = ["stage2.g_phase"] if frozen else ["stage2.d_phase",
                                               "stage2.g_phase"]
    assert [n for n in names if n != "generator"] == ["stage2.step"] + phases
    assert names.count("generator") == 1
    assert all(_inside(s, spans[0]) for s in spans[1:])
    ordered = [s for s in spans if s[0] != "stage2.step"]
    for a, b in zip(ordered, ordered[1:]):        # generator, D, then G
        assert a[2] <= b[1], (a[0], b[0])
    if frozen:
        assert float(metrics["loss_disc"]) == 0.0


def test_spans_change_no_result_and_no_launch_count():
    pipe, mono, feats = _pipeline()
    ops.reset_launch_counts()
    want = pipe(mono, feats)
    counts = ops.launch_counts()
    ops.reset_launch_counts()
    got, spans = _spans(lambda: pipe(mono, feats))
    assert spans and ops.launch_counts() == counts
    assert torch.equal(got, want)
