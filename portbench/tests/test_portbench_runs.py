"""Whole runs of every cell at a tiny size on the CPU: the result line, the
comparison with the plain reference, and the comparison failing when the
timed path is broken underneath."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.reference import bigvgan as ref_bigvgan
from portbench.reference import unet as ref_unet
from portbench.tests import tiny
from portbench.weights import fill_

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.VOCODE, tiny.TRAIN])
@pytest.mark.parametrize("trace", [False, True])
def test_run_is_correct_and_its_line_well_formed(tiny_root, cell, trace):
    r = tiny.run(tiny_root, cell, trace=trace)
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == keys
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    want = {m["name"] for m in harness.load_manifest(tiny_root)[
        "per_layer" if trace else "end_to_end"]
        if harness.applies(m, cell, harness.load_manifest(tiny_root))}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
    json.dumps(r)


def _altered(fn):
    def bad(*args, **kwargs):
        out = fn(*args, **kwargs)
        out = out.clone() if isinstance(out, torch.Tensor) else out.copy()
        out[0, out.shape[1] // 2] += abs(out).max() + 1e-3
        return out
    return bad


def _faults():
    from diffbinaural_tpu_torch.diffusion import GaussianDiffusion
    from diffbinaural_tpu_torch.infer.pipeline import BinauralPipeline
    from diffbinaural_tpu_torch.infer.vocoder import Vocoder

    serve = BinauralPipeline.__call__

    def one_channel(self, *args, **kwargs):
        wav = serve(self, *args, **kwargs)
        return wav[:1].expand_as(wav).clone()

    def unchanged(self, model_fn, condition, generator=None, noise=None,
                  **kwargs):
        return noise

    from diffbinaural_tpu_torch.models import bigvgan

    conv = bigvgan.WNConv1d.forward

    def bias_dropped(self, x, snake=None):
        saved = None if self.b is None else self.b.detach().clone()
        with torch.no_grad():
            if saved is not None:
                self.b.zero_()
            out = conv(self, x, snake=snake)
            if saved is not None:
                self.b.copy_(saved)
        return out

    def snake_at_one(self):
        return torch.zeros_like(self.alpha), torch.zeros_like(self.beta)

    return {
        "vocode-bias-dropped": (tiny.VOCODE, bigvgan.WNConv1d, "forward",
                                bias_dropped),
        "vocode-snake-at-one": (tiny.VOCODE, bigvgan.SnakeBeta, "raw",
                                snake_at_one),
        "vocode-weight-norm-skipped": (tiny.VOCODE, bigvgan, "_weight_norm",
                                       lambda v, g: v),
        "serve-altered": (tiny.SERVE, BinauralPipeline, "__call__",
                          _altered(BinauralPipeline.__call__)),
        "serve-half-left-out": (tiny.SERVE, BinauralPipeline, "__call__",
                                one_channel),
        "serve-sampler-unchanged": (tiny.SERVE, GaussianDiffusion,
                                    "ddim_sample", unchanged),
        "vocode-altered": (tiny.VOCODE, Vocoder, "__call__",
                           _altered(Vocoder.__call__)),
    }


@pytest.mark.parametrize("fault", ["serve-altered", "serve-half-left-out",
                                   "serve-sampler-unchanged",
                                   "vocode-altered", "vocode-bias-dropped",
                                   "vocode-snake-at-one",
                                   "vocode-weight-norm-skipped"])
def test_broken_serving_path_is_not_correct(tiny_root, monkeypatch, fault):
    cell, owner, attr, fn = _faults()[fault]
    monkeypatch.setattr(owner, attr, fn)
    assert not tiny.run(tiny_root, cell)["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_training_step_is_not_correct(tiny_root, monkeypatch, fault):
    import diffbinaural_tpu_torch.train as train

    make = train.make_stage2_train_step

    def broken(*args, **kwargs):
        init_fn, step_fn = make(*args, **kwargs)

        def step(state, batch):
            if fault == "half":
                n = batch["mel"].shape[0] // 2
                return step_fn(state, {k: v[:n] for k, v in batch.items()})
            saved = [p.detach().clone() for p in
                     list(state.generator.parameters())
                     + list(state.mpd.parameters())
                     + list(state.mrd.parameters())]
            state, m = step_fn(state, batch)
            if fault == "unchanged":
                with torch.no_grad():
                    for p, s in zip(list(state.generator.parameters())
                                    + list(state.mpd.parameters())
                                    + list(state.mrd.parameters()), saved):
                        p.copy_(s)
            else:
                m = dict(m, loss_disc=m["loss_disc"] * 1.01)
            return state, m
        return init_fn, step

    monkeypatch.setattr(train, "make_stage2_train_step", broken)
    assert not tiny.run(tiny_root, tiny.TRAIN)["correct"]


def test_no_leaf_starts_as_an_identity():
    """Every bias, gain and snake parameter is drawn away from its identity
    and every weight norm's gain away from ||v||, so a path that leaves one
    out reads another answer than the reference's."""
    from portbench.reference import gan as ref_gan

    h = dict(harness.read_json("portbench/configs/diffbinaural-256x.json"),
             upsample_initial_channel=64, cqtd_filters=8, mpd_reshapes=[2, 3])
    modules = [ref_unet.AudioVisualModel(dim=16, dim_mults=(1, 2, 4),
                                         groups=8, heads=2, dim_head=8,
                                         context_dim=32),
               ref_bigvgan.BigVGAN(h), *ref_gan.build_discriminators(h)]
    for module in modules:
        fill_(module, 5)
        params = dict(module.named_parameters())
        for name, p in params.items():
            assert not torch.all(p == 0) and not torch.all(p == 1), name
            if name.endswith(".g") and name[:-1] + "v" in params:
                v = params[name[:-1] + "v"]
                norm = v.flatten(1).norm(dim=1)
                assert (p / norm - 1).abs().max() > 1e-5, name


def test_reference_models_match_the_port_on_cpu():
    from diffbinaural_tpu_torch.core.config import VocoderConfig
    from diffbinaural_tpu_torch.models import AudioVisualModel, BigVGAN

    kw = dict(dim=16, dim_mults=(1, 2, 4), groups=8, heads=2, dim_head=8,
              context_dim=32)
    ref = ref_unet.AudioVisualModel(**kw)
    port = AudioVisualModel(dim=16, dim_mults=(1, 2, 4), attn_heads=2,
                            attn_dim_head=8, context_dim=32).eval()
    fill_(ref, 3)
    fill_(port, 3)
    x, mono = torch.randn(2, 2, 16, 16), torch.rand(2, 1, 16, 16)
    feats, t = torch.randn(2, 32), torch.tensor([10, 900], dtype=torch.int32)
    with torch.no_grad():
        torch.testing.assert_close(port(x, t, (mono, feats, None)),
                                   ref(x, t, mono, feats), rtol=1e-5,
                                   atol=1e-5)
    h = dict(harness.read_json("portbench/configs/bigvgan-22khz-80band.json"),
             upsample_initial_channel=64)
    ref, port = ref_bigvgan.BigVGAN(h), BigVGAN(VocoderConfig.from_attrdict(h))
    fill_(ref, 4)
    fill_(port, 4)
    mel = torch.randn(1, 80, 12) - 5
    with torch.no_grad():
        torch.testing.assert_close(port(mel), ref(mel), rtol=1e-5, atol=1e-6)


def test_cli_refuses_without_a_card_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for root in (harness.ROOT, str(tmp_path)):
        if root != harness.ROOT:
            shutil.copytree(harness.HERE, os.path.join(root, "portbench"))
            shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload",
             tiny.VOCODE, "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=root, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""
