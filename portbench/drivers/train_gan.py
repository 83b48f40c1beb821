"""Stage-2 GAN training through the port's ``train.stage2`` step: back to
back D + G steps on seeded batches.

A batch is ``batch`` segments of ``segment`` samples of seeded synthetic
audio (``batch / 2`` stereo pairs, one row per channel, as the binaural
trainer feeds its channels) with their ln-mels from the benchmark's own
frontend; ``pool`` batches are made in set-up and the steps cycle through
them, every row of the first ``compared_steps`` different.  Set-up builds
the step once and drives it through its first ``compared_steps`` steps;
those are the warm-up, so the window's steps start from a running
optimiser state.  From them the check keeps each step's D and G loss, each
parameter's first gradient as the optimiser took it (its first Adam moment
over 1 - b1) and each parameter's change over the first and over all the
compared steps, all as norms per leaf; the plain reference, built again
from the seed after the window, takes the same steps on the same batches.
"""

from __future__ import annotations

import statistics

import torch

from .. import roofline
from ..reference import bigvgan as ref_bigvgan
from ..reference import gan as ref_gan
from ..weights import fill_
from . import common

WEIGHTS_G, WEIGHTS_MPD, WEIGHTS_CQTD = 0, 1, 2
# a leaf whose first reference gradient is under this share of the median
# leaf's is moved by round-off alone under Adam: left out of the change
NOUGHT = 1e-3


# the groups of leaves compared apart: the generator and each family of
# discriminators (a fault in one family would not move a median over both)
GROUPS = ("g", "mpd", "cqtd")


def _groups(gen, mpd, cqtd) -> dict:
    """{"g": generator, "mpd": MPD, "cqtd": CQTD leaves}, by name."""
    return {"g": dict(gen.named_parameters()),
            "mpd": dict(mpd.named_parameters()),
            "cqtd": dict(cqtd.named_parameters())}


def _opts(g_opt, d_opt) -> dict:
    """Each group's optimiser: one for the generator, one for both families
    of discriminators."""
    return {"g": g_opt, "mpd": d_opt, "cqtd": d_opt}


def _norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def _steps(step, batches, groups, opts, b1) -> dict:
    """Run ``step(batch) -> (d_loss, g_loss)`` over ``batches``; each loss,
    each leaf's first gradient as the optimiser took it (its first Adam
    moment over 1 - b1), each leaf's change over the first step and over
    all the steps, as norms."""
    start = {k: {n: p.detach().clone() for n, p in ps.items()}
             for k, ps in groups.items()}

    def change():
        return {k: _norms({n: p.detach() - start[k][n]
                           for n, p in groups[k].items()}) for k in groups}

    losses, first, change1 = [], None, None
    for i, batch in enumerate(batches):
        losses.append(step(batch))
        if i == 0:
            first = {k: _norms({n: opts[k].state[p]["exp_avg"] / (1 - b1)
                                for n, p in groups[k].items()})
                     for k in groups}
            change1 = change()
    return {"losses": losses, "first": first, "change1": change1,
            "change": change()}


class Driver:
    def __init__(self, config, traffic, seed, device, spans):
        self.h, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = device, spans

    def _batch(self, k: int) -> dict:
        gen = common.stream(self.seed, 1000 + k, self.device)
        audio = common.synthetic_audio(gen, self.traffic["batch"],
                                       self.traffic["segment"],
                                       self.h["sampling_rate"], self.device)
        return {"mel": ref_gan.mel_spectrogram(audio, self.h, self.h["fmax"]),
                "audio": audio}

    def _port_modules(self):
        from diffbinaural_tpu_torch.core.config import VocoderConfig
        from diffbinaural_tpu_torch.models import (
            BigVGAN, MultiPeriodDiscriminator,
            MultiScaleSubbandCQTDiscriminator)

        h = self.h
        with torch.device(self.device):
            gen = BigVGAN(VocoderConfig.from_attrdict(h))
            mpd = MultiPeriodDiscriminator(periods=tuple(h["mpd_reshapes"]))
            cqtd = MultiScaleSubbandCQTDiscriminator(
                sampling_rate=h["sampling_rate"],
                hop_lengths=tuple(h["cqtd_hop_lengths"]),
                n_octaves=tuple(h["cqtd_n_octaves"]),
                bins_per_octaves=tuple(h["cqtd_bins_per_octaves"]),
                filters=h["cqtd_filters"])
        return gen, mpd, cqtd

    def _ref_modules(self):
        with torch.device(self.device):
            gen = ref_bigvgan.BigVGAN(self.h)
            mpd, cqtd = ref_gan.build_discriminators(self.h)
        return gen, mpd, cqtd

    def _fill(self, gen, mpd, cqtd):
        fill_(gen, common.derive(self.seed, WEIGHTS_G))
        fill_(mpd, common.derive(self.seed, WEIGHTS_MPD))
        fill_(cqtd, common.derive(self.seed, WEIGHTS_CQTD))

    def setup(self):
        from diffbinaural_tpu_torch.losses import MultiScaleMelSpectrogramLoss
        from diffbinaural_tpu_torch.signal import mel_spectrogram
        from diffbinaural_tpu_torch.train import make_stage2_train_step

        h = self.h
        gen, mpd, cqtd = self._port_modules()
        self._fill(gen, mpd, cqtd)

        def mel_fn(wav):
            return mel_spectrogram(wav, h["n_fft"], h["num_mels"],
                                   h["sampling_rate"], h["hop_size"],
                                   h["win_size"], h["fmin"],
                                   h.get("fmax_for_loss"))

        init_fn, self.step_fn = make_stage2_train_step(
            gen, mpd, cqtd, mel_fn,
            MultiScaleMelSpectrogramLoss(h["sampling_rate"]),
            learning_rate=h["learning_rate"], adam_b1=h["adam_b1"],
            adam_b2=h["adam_b2"], lr_decay=h["lr_decay"],
            clip_grad_norm=h["clip_grad_norm"],
            lambda_melloss=h["lambda_melloss"], freeze_step=0,
            use_multiscale_melloss=h["use_multiscale_melloss"],
            silence_threshold_db=h["silence_threshold_db"],
            remat=self.traffic["remat"], device=self.device)
        self.state = init_fn()
        self.hooks = self.spans.hook_module(gen, "generator")
        self.pool = [self._batch(k) for k in range(self.traffic["pool"])]
        self.flops = self._flops()
        self.program = self._first_steps(self.state)
        self.steps = self.traffic["compared_steps"]

    def _first_steps(self, state) -> dict:
        """The compared steps, through the window's own call and feed."""
        holder = [state]

        def step(batch):
            holder[0], m = self.step_fn(holder[0], batch)
            return float(m["loss_disc"]), float(m["loss_gen_all"])

        return _steps(step, self.pool[: self.traffic["compared_steps"]],
                      _groups(state.generator, state.mpd, state.mrd),
                      _opts(state.gen_opt, state.disc_opt),
                      self.h["adam_b1"])

    def _flops(self) -> float:
        """The plain reference's FLOP for one step: the generator's forward
        once, the D step on its detached output, and the G step's losses
        against the discriminators back to the generator."""
        h, b, n = self.h, self.traffic["batch"], self.traffic["segment"]
        gen, mpd, cqtd = (roofline.meta(lambda: ref_bigvgan.BigVGAN(h)),
                          *roofline.meta(lambda: ref_gan.build_discriminators(
                              h)))
        frames = n // h["hop_size"]
        mel = torch.empty((b, h["num_mels"], frames), device="meta")
        y = torch.empty((b, 1, n), device="meta")
        g_params = list(gen.parameters())
        d_params = list(mpd.parameters()) + list(cqtd.parameters())

        def step():
            y_hat = gen(mel)
            d_loss = ref_gan._d_loss((mpd, cqtd), y, y_hat.detach())
            torch.autograd.grad(d_loss, d_params)
            g_loss = (ref_gan.multiscale_mel_loss(y, y_hat, h["sampling_rate"])
                      + ref_gan._g_adv((mpd, cqtd), y, y_hat))
            torch.autograd.grad(g_loss, g_params)

        return roofline.count_flops(step)

    def request(self) -> dict:
        batch = self.pool[self.steps % len(self.pool)]
        self.state, m = self.step_fn(self.state, batch)
        float(m["loss_gen_all"])
        self.steps += 1
        return {"steps": 1, "flops": self.flops}

    def release(self):
        for h in self.hooks:
            h.remove()
        del self.state, self.step_fn, self.pool

    def reference(self, tf32: bool = False, rows=None) -> dict:
        """The plain reference's readings over the compared steps, built
        again from the seed; in TF32 for the control; ``rows`` of each
        batch only, for a fault that leaves part of the batch out."""
        gen, mpd, cqtd = self._ref_modules()
        self._fill(gen, mpd, cqtd)
        step = ref_gan.GanStep(gen, mpd, cqtd, self.h,
                               self.traffic["reference_block"])
        batches = [self._batch(k)
                   for k in range(self.traffic["compared_steps"])]
        if rows is not None:
            batches = [{k: v[rows] for k, v in b.items()} for b in batches]
        with common.precision(tf32):
            return _steps(lambda b: step(b["mel"], b["audio"]), batches,
                          _groups(gen, mpd, cqtd),
                          _opts(step.g_opt, step.d_opt),
                          self.h["adam_b1"])

    def check(self, run) -> dict:
        return compare(self.program, self.reference(), run.limits)


def readings(prog: dict, ref: dict) -> dict:
    """Every number the comparison can hold, program against reference:
    the losses of all steps and of the first; per group (``GROUPS``), the
    first gradient, the change over the first step (``change1``) and the
    change over all the steps, of the worst leaf and of the median leaf."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    out = {"loss_gap": max(rel(a, b) for got, want in
                           zip(prog["losses"], ref["losses"])
                           for a, b in zip(got, want)),
           "loss_gap.first": max(rel(a, b) for a, b in
                                 zip(prog["losses"][0], ref["losses"][0]))}
    for k in GROUPS:
        first = ref["first"][k]
        med = statistics.median(first.values())
        moved = [n for n in first if first[n] >= NOUGHT * med]
        for what, key, keep in (("grad", "first", list(first)),
                                 ("change1", "change1", moved),
                                 ("change", "change", moved)):
            got, want = prog[key][k], ref[key][k]
            scale = statistics.median(want[n] for n in keep)
            gaps = [abs(got[n] - want[n]) / max(want[n], scale)
                    for n in keep]
            out[f"{what}_gap.{k}"] = max(gaps)
            out[f"{what}_gap_median.{k}"] = statistics.median(gaps)
    return out


def compare(prog: dict, ref: dict, limits: dict) -> dict:
    """The numbers that ``limits`` holds, each beside its limit."""
    got = readings(prog, ref)
    return {k: {"value": got[k], "limit": v} for k, v in limits.items()}
