"""Vocoding utterances through the port's ``infer.vocoder.Vocoder``, one
client, closed loop.

Each request is one mono ln-mel of a seeded synthetic utterance, handed to
``Vocoder.__call__`` as the host array a TTS front end would pass; the
waveform comes back to the host.  The utterances' lengths are a fixed set
of ``lengths`` durations that span [``seconds_min``, ``seconds_max``] and
average ``seconds_mean`` (the corpus's published range and mean; see
:func:`durations`), one utterance each, made in set-up.  Every seed sends
the same set
in another order: cycles of seeded permutations, and the window ends on a
whole cycle, so every run's work is the same.  The vocoder pads each to
a multiple of ``pad_multiple`` frames; every padded shape is warmed in
set-up.  The check runs the plain reference over ``check_requests``
finished requests drawn from the seed, the longest among them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import roofline
from ..reference import bigvgan as ref_bigvgan
from ..reference.gan import mel_spectrogram
from ..weights import fill_
from . import common

WEIGHTS = 0
PAD_VALUE = float(np.log(1e-5))


def durations(lo: float, hi: float, mean: float, n: int) -> np.ndarray:
    """``n`` durations lo + (hi - lo) q^p at q evenly over [0, 1], with the
    power p found by bisection so that they average ``mean``: the range and
    the mean are the corpus's, the shape between them an assumption."""
    q = np.linspace(0.0, 1.0, n)
    a, b = 1e-3, 1e3
    for _ in range(200):
        p = (a * b) ** 0.5
        if lo + (hi - lo) * np.mean(q ** p) > mean:
            a = p
        else:
            b = p
    return lo + (hi - lo) * q ** p


class Driver:
    def __init__(self, config, traffic, seed, device, spans):
        self.h, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = device, spans
        self.sr, self.hop = config["sampling_rate"], config["hop_size"]
        seconds = durations(traffic["seconds_min"], traffic["seconds_max"],
                            traffic["seconds_mean"], traffic["lengths"])
        self.lengths = (seconds * self.sr / self.hop).round().astype(int)
        self.rng = np.random.default_rng(common.derive(seed, 1))
        self.order = []

    def _padded(self, frames: int) -> int:
        m = self.traffic["pad_multiple"]
        return -(-frames // m) * m

    def _mel(self, k: int) -> np.ndarray:
        """Utterance ``k``'s ln-mel (1, num_mels, lengths[k]) on the host."""
        gen = common.stream(self.seed, 1000 + k, self.device)
        n = int(self.lengths[k]) * self.hop
        audio = common.synthetic_audio(gen, 1, n, self.sr, self.device)
        mel = mel_spectrogram(audio, self.h, self.h["fmax"])
        return mel[:, :, : self.lengths[k]].cpu().numpy()

    def setup(self):
        from diffbinaural_tpu_torch.core.config import VocoderConfig
        from diffbinaural_tpu_torch.infer.vocoder import Vocoder
        from diffbinaural_tpu_torch.models import BigVGAN

        with torch.device(self.device):
            gen = BigVGAN(VocoderConfig.from_attrdict(self.h))
        fill_(gen, common.derive(self.seed, WEIGHTS))
        self.gen = gen.eval()
        self.vocoder = Vocoder(hop_size=self.hop, model=self.gen,
                               pad_multiple=self.traffic["pad_multiple"],
                               device=self.device)
        self.hooks = (self.spans.hook_module(self.gen, "generator")
                      + common.hook_snake_conv_work(self.gen, self.spans))
        self.pool = [self._mel(k) for k in range(len(self.lengths))]
        shapes = sorted({self._padded(int(t)) for t in self.lengths})
        self.flops = self._flops(shapes)
        for t in shapes:
            k = int(np.argmax([self._padded(int(x)) == t
                               for x in self.lengths]))
            self.vocoder(self.pool[k])

    def _flops(self, shapes) -> dict:
        """The plain reference's FLOP per padded length, counted at the
        shortest and the longest: the generator's work is affine in its
        length (every layer keeps or multiplies it), so the rest lie on the
        line through the two."""
        gen = roofline.meta(lambda: ref_bigvgan.BigVGAN(self.h))
        lo, hi = shapes[0], shapes[-1]
        f_lo, f_hi = (roofline.count_flops(gen, torch.empty(
            (1, self.h["num_mels"], t), device="meta")) for t in (lo, hi))
        slope = (f_hi - f_lo) / max(hi - lo, 1)
        return {t: f_lo + slope * (t - lo) for t in shapes}

    def at_boundary(self) -> bool:
        """Whether the last request closed a cycle of the length set."""
        return not self.order

    def request(self) -> dict:
        if not self.order:
            self.order = list(self.rng.permutation(len(self.lengths)))
        k = int(self.order.pop(0))
        wav = self.vocoder(self.pool[k])
        frames = int(self.lengths[k])
        return {"item": k, "wav": wav, "audio_s": wav.shape[-1] / self.sr,
                "flops": self.flops[self._padded(frames)]}

    def release(self):
        for h in self.hooks:
            h.remove()
        del self.vocoder, self.gen

    @torch.no_grad()
    def reference(self, items, tf32: bool = False) -> list:
        """The plain reference's waveforms (1, samples) of utterances
        ``items``, padded as the vocoder pads them; in TF32 for the
        control."""
        with torch.device(self.device):
            gen = ref_bigvgan.BigVGAN(self.h)
        fill_(gen, common.derive(self.seed, WEIGHTS))
        out = []
        with common.precision(tf32):
            for k in items:
                t = int(self.lengths[k])
                mel = torch.full((1, self.h["num_mels"], self._padded(t)),
                                 PAD_VALUE, device=self.device)
                mel[:, :, :t] = torch.from_numpy(self._mel(k)).to(self.device)
                out.append(gen(mel)[:, 0, : t * self.hop])
        return out

    def check(self, run) -> dict:
        done = [r for r in run.requests if not r.get("failed")]
        longest = max(range(len(done)), key=lambda i: done[i]["audio_s"])
        chosen = [done[i] for i in common.pick(
            self.seed, done, self.traffic["check_requests"], must=(longest,))]
        want = self.reference([r["item"] for r in chosen])
        gap = max(common.rel_gap(torch.from_numpy(np.asarray(r["wav"])).to(
            self.device), w) for r, w in zip(chosen, want))
        return {"wave_gap": {"value": gap, "limit": run.limits["wave_gap"]}}
