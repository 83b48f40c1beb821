"""Serving whole clips through the port's pipeline, one client, closed loop.

Each request is one clip: a seeded mono ln-mel of ``clip_seconds`` and its
per-window visual features, with its x_T drawn by the benchmark, through
``infer.pipeline.BinauralPipeline.__call__`` (windows in groups of
``unet_batch``, the configured sampler, the vocoder on both channels), the
waveform copied to the host.  Requests cycle through a pool of ``pool``
clips made in set-up.

The check follows the program step by step.  With random weights the
sampler is chaotic: two float32 orders of the same sums part after some
DDIM steps (whole clips read up to 0.30 of the waveform's scale apart), so
whole clips cannot be compared.  The window's first ``record_from``
requests are recorded by forward hooks into buffers made in set-up (no
allocation in the window): the UNet's input state and output at every call
and the stitched ln-mels the vocoder takes.  Of those that finish,
``check_requests`` drawn from the seed are checked: the plain reference
takes every stage from the
program's own state: ``step_gap`` is the worst of the first state against
the benchmark's x_T, each UNet output against the reference UNet on the
same state (its own windows and features), each next state against the
DDIM update of the program's state and output, and the stitched ln-mels
against the reference's stitch of the last updates; ``wave_gap`` is the
waveform against the reference vocoder on the program's stitched ln-mels.
"""

from __future__ import annotations

import torch

from .. import roofline
from ..reference import bigvgan as ref_bigvgan
from ..reference import clip as ref_clip
from ..reference import unet as ref_unet
from ..reference.gan import mel_spectrogram
from ..weights import fill_
from . import common

WEIGHTS_UNET, WEIGHTS_GEN = 0, 1


class Driver:
    def __init__(self, config, traffic, seed, device, spans):
        self.h, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = device, spans
        s1 = config["stage1"]
        self.s1 = s1
        self.sr, self.hop = config["sampling_rate"], config["hop_size"]
        n = int(traffic["clip_seconds"] * self.sr)
        self.samples = n
        self.frames = 1 + (n + 2 * ((config["n_fft"] - self.hop) // 2)
                           - config["n_fft"]) // self.hop
        self.starts = ref_clip.window_starts(self.frames, s1["window"],
                                             s1["stride"])
        self.groups = -(-len(self.starts) // traffic["unet_batch"])

    def _unet_kwargs(self):
        s1 = self.s1
        return dict(dim=s1["dim"], dim_mults=tuple(s1["dim_mults"]),
                    groups=s1["resnet_block_groups"], heads=s1["attn_heads"],
                    dim_head=s1["attn_dim_head"],
                    context_dim=s1["context_dim"])

    def _inputs(self, i):
        """(mono ln-mel (1, M, T), features (n_windows, C), x_T per group)."""
        gen = common.stream(self.seed, 1000 + i, self.device)
        s1, ub = self.s1, self.traffic["unet_batch"]
        audio = common.synthetic_audio(gen, 1, self.samples, self.sr,
                                       self.device)
        mel = mel_spectrogram(audio, self.h, self.h["fmax"])
        feats = torch.randn((len(self.starts), s1["context_dim"]),
                            generator=gen, device=self.device)
        noise = torch.randn((self.groups, ub, 2, self.h["num_mels"],
                             s1["window"]), generator=gen, device=self.device)
        return mel, feats, noise

    def setup(self):
        from diffbinaural_tpu_torch.core.config import VocoderConfig
        from diffbinaural_tpu_torch.infer.pipeline import BinauralPipeline
        from diffbinaural_tpu_torch.models import AudioVisualModel, BigVGAN

        s1, kw = self.s1, self._unet_kwargs()
        with torch.device(self.device):
            unet = AudioVisualModel(
                dim=kw["dim"], input_nc=2, output_nc=2,
                dim_mults=kw["dim_mults"],
                resnet_block_groups=kw["groups"], attn_heads=kw["heads"],
                attn_dim_head=kw["dim_head"], context_dim=kw["context_dim"])
            gen = BigVGAN(VocoderConfig.from_attrdict(self.h))
        fill_(unet, common.derive(self.seed, WEIGHTS_UNET))
        fill_(gen, common.derive(self.seed, WEIGHTS_GEN))
        self.unet, self.gen = unet.eval(), gen.eval()
        self.pipe = BinauralPipeline(
            unet, gen, self.frames, num_mels=self.h["num_mels"],
            window=s1["window"], stride=s1["stride"],
            crop_frames=s1["crop_frames"],
            unet_batch=self.traffic["unet_batch"],
            sampling_timesteps=s1["sampling_timesteps"], sampler="ddim",
            device=self.device)
        calls = self.groups * self.s1["sampling_timesteps"]
        shape = (calls, self.traffic["unet_batch"], 2, self.h["num_mels"],
                 s1["window"])
        self.slots = [{"states": torch.empty(shape, device=self.device),
                       "outs": torch.empty(shape, device=self.device),
                       "mel": torch.empty((2, self.h["num_mels"],
                                           self.frames), device=self.device),
                       "calls": 0} for _ in range(
                           self.traffic["record_from"])]
        self.recording = None

        def keep_unet(mod, args, out):
            rec = self.recording
            if rec is not None and rec["calls"] < calls:
                rec["states"][rec["calls"]].copy_(args[0])
                rec["outs"][rec["calls"]].copy_(out)
            if rec is not None:
                rec["calls"] += 1

        def keep_mel(mod, args, out):
            if self.recording is not None:
                self.recording["mel"].copy_(args[0])

        self.hooks = ([unet.register_forward_hook(keep_unet),
                       gen.register_forward_hook(keep_mel)]
                      + self.spans.hook_module(unet, "unet")
                      + self.spans.hook_module(gen, "generator")
                      + common.hook_attention_work(unet, self.spans)
                      + common.hook_snake_conv_work(gen, self.spans))
        self.pool = [self._inputs(i) for i in range(self.traffic["pool"])]
        self.flops = self._flops()
        self.served = 0
        mel, feats, noise = self._inputs(-1)
        self.pipe(mel, feats, noise=noise).cpu()

    def _flops(self) -> float:
        """The plain reference's FLOP for one clip: every UNet call of the
        sampler at ``unet_batch`` rows, and the vocoder on both channels."""
        dev = "meta"
        unet = roofline.meta(lambda: ref_unet.AudioVisualModel(
            **self._unet_kwargs()))
        gen = roofline.meta(lambda: ref_bigvgan.BigVGAN(self.h))
        ub, w, m = self.traffic["unet_batch"], self.s1["window"], self.h[
            "num_mels"]
        x = torch.empty((ub, 2, m, w), device=dev)
        call = roofline.count_flops(
            unet, x, torch.zeros((ub,), dtype=torch.int32, device=dev),
            torch.empty((ub, 1, m, w), device=dev),
            torch.empty((ub, self.s1["context_dim"]), device=dev))
        voc = roofline.count_flops(
            gen, torch.empty((2, m, self.frames), device=dev))
        return (self.groups * self.s1["sampling_timesteps"] * call) + voc

    def request(self) -> dict:
        k = self.served % len(self.pool)
        mel, feats, noise = self.pool[k]
        if self.served < len(self.slots):
            self.recording = self.slots[self.served]
        wav = self.pipe(mel, feats, noise=noise).cpu()
        out = {"item": k, "wav": wav, "audio_s": wav.shape[-1] / self.sr,
               "flops": self.flops}
        if self.recording is not None:
            out["recorded"] = self.recording
        self.recording = None
        self.served += 1
        return out

    def release(self):
        for h in self.hooks:
            h.remove()
        del self.pipe, self.unet, self.gen, self.pool

    def _ref_models(self):
        with torch.device(self.device):
            unet = ref_unet.AudioVisualModel(**self._unet_kwargs())
            gen = ref_bigvgan.BigVGAN(self.h)
        fill_(unet, common.derive(self.seed, WEIGHTS_UNET))
        fill_(gen, common.derive(self.seed, WEIGHTS_GEN))
        return unet, gen

    @torch.no_grad()
    def serve_reference(self, k: int, tf32: bool = False) -> dict:
        """The plain reference's own run of pool clip ``k``, recorded as a
        request is; in TF32 for the control."""
        unet, gen = self._ref_models()
        mel, feats, noise = self._inputs(k)
        s1 = self.s1
        with common.precision(tf32):
            run = ref_clip.serve(unet, gen, mel, feats, noise,
                                 s1["sampling_timesteps"], s1["window"],
                                 s1["stride"], s1["crop_frames"])
        return dict(run, item=k, calls=len(run["states"]))

    @torch.no_grad()
    def follow(self, runs) -> dict:
        """Hold each recorded run against the plain reference, stage by
        stage from the run's own states: the worst ``step_gap`` and
        ``wave_gap``."""
        unet, gen = self._ref_models()
        s1, ub = self.s1, self.traffic["unet_batch"]
        pairs = ref_clip.ddim_pairs(s1["sampling_timesteps"])
        ddim = ref_clip.Ddim(self.device)
        step = wave = 0.0
        if not runs:
            return {"step_gap": float("inf"), "wave_gap": float("inf")}
        for r in runs:
            mel, feats, noise = self._inputs(r["item"])
            wins, feats = ref_clip.windows(mel, feats, self.groups * ub,
                                           s1["window"], s1["stride"])
            n = len(pairs)
            if r["calls"] != self.groups * n:
                return {"step_gap": float("inf"), "wave_gap": float("inf")}
            preds = []
            for g in range(self.groups):
                rows = slice(g * ub, (g + 1) * ub)
                xs, outs = r["states"][g * n:(g + 1) * n], r["outs"][
                    g * n:(g + 1) * n]
                step = max(step, common.rel_gap(xs[0], noise[g]))
                for i, (time, time_next) in enumerate(pairs):
                    want = ddim.eps(unet, xs[i], time, wins[rows], feats[rows])
                    step = max(step, common.rel_gap(outs[i], want))
                    nxt = ddim.update(xs[i], outs[i], time, time_next)
                    if time_next < 0:
                        preds.append(nxt)
                    else:
                        step = max(step, common.rel_gap(xs[i + 1], nxt))
            stitched = ref_clip.stitch(torch.cat(preds), mel.shape[2],
                                       s1["window"], s1["stride"],
                                       s1["crop_frames"])
            step = max(step, common.rel_gap(r["mel"], stitched))
            wave = max(wave, common.rel_gap(r["wav"].to(self.device),
                                            gen(r["mel"])[:, 0]))
        return {"step_gap": step, "wave_gap": wave}

    def check(self, run) -> dict:
        done = [r for r in run.requests
                if "recorded" in r and not r.get("failed")]
        gaps = self.follow([
            dict(done[i]["recorded"], item=done[i]["item"], wav=done[i]["wav"])
            for i in common.pick(self.seed, done,
                                 self.traffic["check_requests"])])
        return {k: {"value": v, "limit": run.limits[k]}
                for k, v in gaps.items()}
