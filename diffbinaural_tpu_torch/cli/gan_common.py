"""Shared stage-2 GAN training loop — counterpart of
``diffbinaural_tpu/cli/gan_common.py``: the config-driven discriminators
(``models.build_discriminators``), the three-tier resume (the stage-2
directory, then ``--stage1_checkpoint_path`` with
``--load_stage1_checkpoint``, then scratch), ``g_%08d`` / ``do_%08d``
checkpoints, periodic stdout / TensorBoard / validation, the per-step LR
decay inside the step, and the curriculum's epoch update.

The generator computes in bfloat16 (float32 parameters), the
discriminators in float32 unless the config sets ``discriminator_bf16``.
``remat`` (recompute the forwards in the backward pass) is on when
``batch_size * segment_size`` exceeds 16 x 16384, as in the JAX trainer:
the production config's batch 32 turns it on.

Checkpoints are the JAX trainer's files: ``g_%08d`` holds
``{"generator": variables}``, ``do_%08d`` ``{"mpd", "mrd", "steps",
"epoch"}``, flax msgpack under the flax names (``convert.py``).  Resume
restores the parameters and the step counter; the optimisers start afresh,
as the JAX trainer's do.

Data-parallel over ``parallel.make_mesh()``, as the JAX trainer is (one
process per card under ``python -m torch.distributed.run``, the card unless
``device="cpu"``): every rank runs the same loader and keeps its block of
each batch; the generator goes through ``parallel.shard_vocoder_params``
(a plain replicate on the default mesh, whose ``model`` size is 1) and is
gathered whole for a checkpoint.  Validation runs on every rank; rank 0
alone writes checkpoints, summaries and figures.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np
import torch

from ..convert import bigvgan_params_from_flax, discriminator_params_from_flax
from ..core import checkpoint as ckpt
from ..core.config import AttrDict, VocoderConfig, build_env
from ..core.device import resolve_device
from ..core.precision import full_precision
from ..losses import MultiScaleMelSpectrogramLoss
from ..models import build_discriminators, build_vocoder
from ..parallel.mesh import (is_main_process, load_gathered_state_dict,
                             make_mesh, shard_batch, shard_vocoder_params)
from ..signal.stft import mel_spectrogram
from ..train import make_stage2_train_step
from ..utils import SummaryLogger
from .common import module_tree

__all__ = ["GanTrainer", "build_discriminators", "load_config"]


class GanTrainer:
    def __init__(self, a, h: AttrDict, compute_dtype=torch.bfloat16, *,
                 device=None):
        self.a = a
        self.h = h
        self.device = resolve_device(device)
        self.mesh = make_mesh(devices=self.device)
        self.is_main = is_main_process()
        self.cfg = VocoderConfig.from_attrdict(h)
        self.compute_dtype = compute_dtype
        self.disc_dtype = (torch.bfloat16 if h.get("discriminator_bf16", False)
                           else torch.float32)
        self.msl = MultiScaleMelSpectrogramLoss(h["sampling_rate"])
        self.writer = SummaryLogger(
            os.path.join(a.checkpoint_path, "logs") if self.is_main else None)
        # remat costs step time; the JAX trainer turns it on above one
        # chip's activation footprint (B = 16 x 16384 fits, B = 32 needs it)
        self.remat = h["batch_size"] * h["segment_size"] > 16 * 16384
        self.gen = self.mpd = self.mrd = None
        self.state = None
        self.step_fn = None
        self.steps = 0
        self.last_epoch = -1
        # host seconds per step: waiting on the loader, and the whole step
        self.timings: Dict = {"wait_s": [], "step_s": []}

    def mel_fn(self, wav):
        h = self.h
        return mel_spectrogram(wav, h["n_fft"], h["num_mels"],
                               h["sampling_rate"], h["hop_size"],
                               h["win_size"], h["fmin"],
                               h.get("fmax_for_loss"))

    # ------------------------------------------------------------------

    def init_params(self, seg_frames: int):
        """Generator and discriminators with random weights from the
        config's seed, and a fresh optimiser state.  (``seg_frames`` gives
        the JAX trainer its init shapes; the modules need none.)"""
        h, seed = self.h, self.h["seed"]
        self.gen = shard_vocoder_params(
            build_vocoder(self.cfg, dtype=self.compute_dtype, seed=seed,
                          device=self.device), self.mesh)
        self.mpd, self.mrd = build_discriminators(
            h, dtype=self.disc_dtype, seed=seed + 1, device=self.device)
        init_fn, self.step_fn = make_stage2_train_step(
            self.gen, self.mpd, self.mrd, self.mel_fn, self.msl,
            learning_rate=h["learning_rate"], adam_b1=h["adam_b1"],
            adam_b2=h["adam_b2"], lr_decay=h["lr_decay"],
            clip_grad_norm=h.get("clip_grad_norm", 1000.0),
            lambda_melloss=h.get("lambda_melloss", 45.0),
            freeze_step=getattr(self.a, "freeze_step", 0),
            use_multiscale_melloss=h.get("use_multiscale_melloss", False),
            silence_threshold_db=h.get("silence_threshold_db", -50.0),
            remat=self.remat, device=self.device, mesh=self.mesh)
        self.state = init_fn()

    def _load_generator(self, path: str) -> None:
        g = ckpt.load_checkpoint(path, {"generator": module_tree(self.gen)})
        load_gathered_state_dict(self.gen,
                                 bigvgan_params_from_flax(g["generator"]))

    def try_resume(self):
        """Three tiers: the stage-2 directory -> the stage-1 directory
        (``--load_stage1_checkpoint``) -> scratch."""
        d = self.a.checkpoint_path
        os.makedirs(d, exist_ok=True)
        cp_g = ckpt.scan_checkpoint(d, "g_", renamed_file="bigvgan_generator.pt")
        cp_do = ckpt.scan_checkpoint(
            d, "do_", renamed_file="bigvgan_discriminator_optimizer.pt")
        if cp_g and cp_do:
            self._load_generator(cp_g)
            do = ckpt.load_checkpoint(cp_do)
            for name, module in (("mpd", self.mpd), ("mrd", self.mrd)):
                tree = ckpt.serialization.from_state_dict(
                    module_tree(module), do[name])
                module.load_state_dict(discriminator_params_from_flax(tree),
                                       strict=True)
            self.steps = int(do["steps"]) + 1
            self.state.step = self.steps
            self.last_epoch = int(do["epoch"])
            print(f"Resumed stage-2 from {cp_g} at step {self.steps}")
            return
        s1 = getattr(self.a, "stage1_checkpoint_path", None)
        if s1 and getattr(self.a, "load_stage1_checkpoint", False):
            cp_g = ckpt.scan_checkpoint(s1, "g_")
            if cp_g:
                self._load_generator(cp_g)
                print(f"Warm-started generator from stage-1 dir {cp_g}")

    def save(self, epoch: int):
        """``g_`` / ``do_`` at this step, written by rank 0 (every rank
        gathers a sharded generator)."""
        d = self.a.checkpoint_path
        generator = module_tree(self.gen)
        if not self.is_main:
            return
        ckpt.save_checkpoint(os.path.join(d, f"g_{self.steps:08d}"),
                             {"generator": generator})
        ckpt.save_checkpoint(
            os.path.join(d, f"do_{self.steps:08d}"),
            {"mpd": module_tree(self.mpd), "mrd": module_tree(self.mrd),
             "steps": self.steps, "epoch": epoch})

    # ------------------------------------------------------------------

    def validate(self, loader, max_samples: int = 10):
        """Mel L1 of the generator's output against the loss mel over
        ``max_samples`` validation items (the first of each batch)."""
        errs = []
        for i, batch in enumerate(loader):
            mel = torch.from_numpy(batch["mel"][:1]).to(self.device)
            with torch.inference_mode(), full_precision():
                y_hat = self.gen(mel).float()
                y_hat_mel = self.mel_fn(y_hat[:, 0, :]).cpu().numpy()
            y_hat = y_hat.cpu().numpy()
            t = min(y_hat_mel.shape[-1], batch["mel_loss"].shape[-1])
            errs.append(
                float(np.mean(np.abs(batch["mel_loss"][:1, :, :t]
                                     - y_hat_mel[:, :, :t])))
            )
            if i == 0:
                self.writer.mel_figure("val/pred_mel", y_hat_mel[0],
                                       self.steps, vmin=-11, vmax=2)
                self.writer.audio("val/audio", y_hat[0, 0], self.steps,
                                  self.h["sampling_rate"])
            if len(errs) >= max_samples:
                break
        val_err = float(np.mean(errs)) if errs else float("nan")
        self.writer.scalar("validation/mel_spec_error", val_err, self.steps)
        print(f"step {self.steps} validation mel error: {val_err:.4f}")
        return val_err

    def train(self, loader_train, loader_val, dataset_train=None):
        a = self.a
        t0 = time.time()
        for epoch in range(max(0, self.last_epoch), a.training_epochs):
            if dataset_train is not None and hasattr(dataset_train,
                                                    "update_epoch"):
                dataset_train.update_epoch(epoch)  # curriculum
                p = dataset_train.get_pred_mel_probability()
                print(f"epoch {epoch}: P(pred mel) = {p:.2f}")
                self.writer.scalar("training/pred_mel_prob", p, self.steps)
            loader_train.set_epoch(epoch)
            tic = time.time()
            for batch in loader_train:
                wait = time.time() - tic
                b = shard_batch({k: batch[k] for k in
                                 ("mel", "audio", "mel_loss")}, self.mesh)
                b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device) for k, v in b.items()}
                self.state, metrics = self.step_fn(self.state, b)
                self.steps = self.state.step

                if self.steps % a.stdout_interval == 0:
                    dt = time.time() - t0
                    t0 = time.time()
                    print(
                        f"Steps: {self.steps:d}, Gen Loss: "
                        f"{float(metrics['loss_gen_all']):4.3f}, Mel Error: "
                        f"{float(metrics['loss_mel']):4.3f}, "
                        f"s/b: {dt / max(a.stdout_interval, 1):4.3f}"
                    )
                if self.steps % a.summary_interval == 0:
                    for k in ("loss_disc", "loss_gen_all", "loss_mel",
                              "loss_fm", "grad_norm_g", "lr"):
                        self.writer.scalar(f"training/{k}",
                                           float(metrics[k]), self.steps)
                if self.steps % a.checkpoint_interval == 0 and self.steps:
                    self.save(epoch)
                if (self.steps % a.validation_interval == 0
                        and not getattr(a, "debug", False)):
                    self.validate(loader_val)
                self.timings["wait_s"].append(wait)
                self.timings["step_s"].append(time.time() - tic)
                tic = time.time()
        self.writer.close()


def load_config(a) -> AttrDict:
    with open(a.config) as f:
        h = AttrDict(json.loads(f.read()))
    build_env(a.config, "config.json", a.checkpoint_path)
    return h
