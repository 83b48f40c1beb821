"""Shared CLI machinery — counterpart of ``diffbinaural_tpu/cli/common.py``:
``ModelBuilder``, the encoders' routing by family, the stage-1 trainer
(train / eval / checkpoint epoch loop) and full-clip mel dumping.  Where the
JAX functions take a parameter tree, these take the port's modules, which
hold their weights.

``Stage1Trainer`` is the JAX trainer's loop, data-parallel over
``parallel.make_mesh()`` as the JAX trainer is over its mesh (one process
per card under ``python -m torch.distributed.run``, one device without a
launcher): AdamW with two LR groups, x0.95 at each ``--lr_steps`` epoch
passed and x``decay_factor`` every ``learning_rate_decrease_itr`` epochs,
a DDIM-25 mel-L2 evaluation every ``eval_epoch`` epochs, latest / best /
numbered / history checkpoints, and resume by prefix scan.  Its checkpoints are the JAX
trainer's files: flax msgpack under the flax names (``convert.py``), so
either trainer resumes from the other's.  Resume restores the parameters
only; the optimiser starts afresh, as the JAX trainer's does.  The step's
draws (t, noise, CFG drop) come from a ``torch.Generator`` on the device
seeded by ``--seed``.

Every rank runs the same seeded loader over the global batch and keeps its
block of rows (``parallel.shard_batch``), the JAX trainer's data semantics;
the step's loss and gradient norm are global, so the stabiliser and the LR
schedule decide alike on every rank.  Validation runs whole on every rank
(the same numbers at any world size); rank 0 alone writes checkpoints,
summaries and figures.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from ..convert import (tree_to_flax, unet_params_from_flax,
                       visual_params_from_flax)
from ..core import checkpoint as ckpt
from ..core.config import UnetConfig
from ..core.device import resolve_device
from ..core.precision import full_precision
from ..diffusion import GaussianDiffusion
from ..infer.stage1 import Stage1Sampler, generate_clip
from ..models import build_unet
from ..models.visual import ENCODER_REGISTRY, apply_visual, build_visual
from ..parallel.mesh import (gathered_state_dict, is_main_process, make_mesh,
                             shard_batch)
from ..train import TrainingStabilizer, make_stage1_train_step
from ..utils import AverageMeter, SummaryLogger


class ModelBuilder:
    """``build_visual`` / ``build_unet`` with the JAX builder's arguments
    (``pool_type``, ``input_channel``, ``fc_out`` and ``weights`` are
    accepted and unused there too); random weights from ``seed``, on the
    card unless ``device="cpu"``."""

    def build_visual(self, pool_type="maxpool", input_channel=3, fc_out=512,
                     weights="", arch_frame="resnet18", clip_config=None, *,
                     seed=0, device=None):
        kwargs = {}
        if clip_config is not None and arch_frame.startswith("clip"):
            kwargs["clip"] = clip_config
        return build_visual(arch_frame, seed=seed, device=device, **kwargs)

    def build_unet(self, dim=64, input_nc=2, output_nc=2, weights="", *,
                   dtype=torch.float32, seed=0, device=None):
        config = UnetConfig(dim=dim, in_channels=input_nc,
                            out_channels=output_nc)
        return build_unet(config, dtype=dtype, seed=seed, device=device)


def visual_apply_fn(net, arch_frame: str):
    """``apply(frames, pos2d, mask, pos3d=None)`` -> (B, 512) for the
    encoder ``net`` of family ``arch_frame`` (``models.visual.apply_visual``
    routes it)."""
    if not isinstance(net, ENCODER_REGISTRY[arch_frame]):
        raise ValueError(f"{type(net).__name__} is not a {arch_frame!r} "
                         "encoder")

    @full_precision()
    def apply(frames, pos2d, mask, pos3d=None):
        return apply_visual(net, frames, pos2d, mask, pos3d)

    return apply


def module_tree(module: torch.nn.Module) -> Dict:
    """The flax variables ``{"params": tree}`` of one of the port's modules,
    as the JAX trainers hold and save them (a module sharded over a mesh's
    ``model`` axis is gathered whole: every rank calls this)."""
    return {"params": tree_to_flax(gathered_state_dict(module))}


class Stage1Trainer:
    """The stage-1 epoch loop over the job's mesh (the card unless
    ``device="cpu"``).  ``args`` is ``cli.arguments.ArgParser``'s namespace;
    ``args.unet_dim`` and ``args.clip_config``, where set, shrink the models
    (tests)."""

    def __init__(self, args, dataset_train, dataset_val, mel_key="mono_mel",
                 *, device=None):
        self.args = args
        self.mel_key = mel_key
        self.device = resolve_device(device)
        self.mesh = make_mesh(devices=self.device)
        self.is_main = is_main_process()
        builder = ModelBuilder()
        self.net_frame = builder.build_visual(
            pool_type=args.img_pool, arch_frame=args.arch_frame,
            clip_config=getattr(args, "clip_config", None), seed=args.seed,
            device=self.device)
        self.net_unet = builder.build_unet(
            dim=getattr(args, "unet_dim", 64), seed=args.seed,
            device=self.device)
        self.diffusion = GaussianDiffusion(
            image_size=80, timesteps=1000, sampling_timesteps=25,
            loss_type=args.loss, objective="pred_noise",
            beta_schedule="cosine", auto_normalize=False, device=self.device)
        self.visual_apply = visual_apply_fn(self.net_frame, args.arch_frame)
        self.stabilizer = TrainingStabilizer()
        self.dataset_train = dataset_train
        self.dataset_val = dataset_val
        self.exp_dir = os.path.join(args.ckpt, args.id)
        self.writer = SummaryLogger(
            os.path.join(self.exp_dir, "runs") if self.is_main else None)
        self.history: Dict = {"train_loss": [], "val_mel_l2": [], "epoch": 0}
        self.best_mel_l2 = float("inf")
        # host seconds per step: waiting on the loader, and the whole step
        self.timings: Dict = {"wait_s": [], "step_s": []}

        self._init_fn, self.step_fn = make_stage1_train_step(
            self.net_unet, self.net_frame, self.diffusion,
            lr_unet=args.lr_unet, lr_frame=args.lr_frame, b1=args.beta1,
            weight_decay=args.weight_decay, device=self.device,
            mesh=self.mesh)
        self.sampler = Stage1Sampler(self.net_unet, self.diffusion,
                                     sampling_timesteps=25, device=self.device)
        self.state = None
        self.start_epoch = 0

    # ------------------------------------------------------------------

    def init_params(self, batch=None):
        """Warm starts (``--weights_frame``, ``--weights_unet``), then a
        fresh optimiser state.  The modules were built with random weights
        from ``--seed``; ``batch`` (the JAX trainer takes its shapes from
        it) is not needed."""
        self._maybe_load_frame_weights()
        self._maybe_load_unet_weights()
        self.state = self._init_fn()

    def _maybe_load_frame_weights(self):
        """--weights_frame: a msgpack tree of the encoder, or for resnet18 a
        torchvision state dict grafted onto the trunk."""
        path = getattr(self.args, "weights_frame", "")
        if not path:
            return
        if not os.path.exists(path):
            # training from random weights would waste the whole run
            raise FileNotFoundError(f"--weights_frame {path!r} not found")
        tree = module_tree(self.net_frame)
        if (self.args.arch_frame == "resnet18"
                and path.endswith((".pth", ".pt"))
                and ckpt.is_torchvision_resnet18_sd(path)):
            print(f"grafting torchvision resnet18 weights from {path}")
            tree = ckpt.graft_resnet18_trunk(tree, path)
        else:
            print(f"loading frame-encoder checkpoint {path}")
            tree = ckpt.load_checkpoint(path, target=tree)
        self.net_frame.load_state_dict(visual_params_from_flax(tree),
                                       strict=True)

    def _maybe_load_unet_weights(self):
        """--weights_unet: a msgpack tree of the UNet."""
        path = getattr(self.args, "weights_unet", "")
        if not path:
            return
        if not os.path.exists(path):
            raise FileNotFoundError(f"--weights_unet {path!r} not found")
        print(f"loading unet checkpoint {path}")
        tree = ckpt.load_checkpoint(path, target=module_tree(self.net_unet))
        self.net_unet.load_state_dict(unet_params_from_flax(tree), strict=True)

    def _prep_batch(self, batch, shard: bool = True) -> Dict[str, torch.Tensor]:
        """The loader's numpy batch -> the step's keys (with ``shard``, this
        rank's block of rows), copied to the device once."""
        pos = (batch["pos_data"] if self.args.arch_frame == "clip_pos"
               else batch["2d_pos_data"])
        out = {"mono_mel": batch[self.mel_key],
               "binaural_mel": batch["binaural_mel"],
               "frames": batch["frames"], "pos": pos, "mask": batch["mask"]}
        if shard:
            out = shard_batch(out, self.mesh)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in out.items()}

    # ------------------------------------------------------------------

    def lr_scale_for_epoch(self, epoch: int) -> float:
        """x0.95 at each lr_steps epoch passed; x decay_factor every
        learning_rate_decrease_itr epochs."""
        scale = 1.0
        for e in self.args.lr_steps:
            if epoch >= e:
                scale *= 0.95
        itr = self.args.learning_rate_decrease_itr
        if itr and itr > 0:
            scale *= self.args.decay_factor ** (epoch // itr)
        return scale

    def train_epoch(self, loader, epoch: int, generator) -> float:
        meter = AverageMeter()
        batch_timer = AverageMeter()
        tic = time.time()
        self.state.lr_scale = self.lr_scale_for_epoch(epoch)
        for i, batch in enumerate(loader):
            wait = time.time() - tic
            self.state, metrics = self.step_fn(
                self.state, self._prep_batch(batch), generator=generator)
            loss = float(metrics["loss"])
            meter.update(loss)
            self.stabilizer.training_step(loss, float(metrics["grad_norm"]))
            batch_timer.update(time.time() - tic)
            self.timings["wait_s"].append(wait)
            self.timings["step_s"].append(time.time() - tic)
            tic = time.time()
            if i % self.args.disp_iter == 0:
                step = self.state.step
                print(f"Epoch: [{epoch}][{i}/{len(loader)}] "
                      f"time: {batch_timer.average():.3f} loss: {loss:.4f}")
                self.writer.scalar("train/loss", loss, step)
                self.writer.scalar("train/lr_scale", self.state.lr_scale, step)
        return meter.average() if meter.initialized else 0.0

    def evaluate(self, loader, epoch: int) -> float:
        """DDIM-25 over the validation batches (x_T from seed 13, as the
        sampler draws it); per-sample mel L2 against the target.  Every rank
        evaluates every batch whole."""
        errs = []
        for bi, batch in enumerate(loader):
            b = self._prep_batch(batch, shard=False)
            with torch.inference_mode():
                feat = self.visual_apply(b["frames"], b["pos"], b["mask"])
                pred = self.sampler.sample(b["mono_mel"], feat)
            pred = pred.float().cpu().numpy()
            target = batch["binaural_mel"]
            errs.extend(np.mean((pred - target) ** 2, axis=(1, 2, 3)))
            if bi == 0:
                self.writer.mel_figure("val/pred_L", pred[0, 0], epoch)
                self.writer.mel_figure("val/gt_L", target[0, 0], epoch)
            if self.args.num_val > 0 and len(errs) >= self.args.num_val:
                break
        mel_l2 = float(np.mean(errs)) if errs else float("nan")
        print(f"[Eval] epoch {epoch} mel_l2: {mel_l2:.4f}")
        self.writer.scalar("val/mel_l2", mel_l2, epoch)
        return mel_l2

    # ------------------------------------------------------------------

    def save_checkpoints(self, epoch: int, mel_l2: float):
        """latest / best + numbered + history, written by rank 0."""
        d = self.exp_dir
        best = mel_l2 < self.best_mel_l2
        if best:
            self.best_mel_l2 = mel_l2
        if not self.is_main:
            return
        frame, unet = module_tree(self.net_frame), module_tree(self.net_unet)
        ckpt.save_checkpoint(os.path.join(d, "frame_latest.pth"), frame)
        ckpt.save_checkpoint(os.path.join(d, "unet_latest.pth"), unet)
        if best:
            ckpt.save_checkpoint(os.path.join(d, "frame_best.pth"), frame)
            ckpt.save_checkpoint(os.path.join(d, "unet_best.pth"), unet)
        if epoch % max(self.args.eval_epoch * 10, 1) == 0:
            ckpt.save_checkpoint(os.path.join(d, f"frame_{epoch:06d}"), frame)
            ckpt.save_checkpoint(os.path.join(d, f"unet_{epoch:06d}"), unet)
            ckpt.save_history(os.path.join(d, f"history_{epoch:06d}"),
                              self.history)

    def try_resume(self):
        """The newest numbered checkpoints (prefix scan): parameters only,
        the optimiser re-initialised."""
        d = self.exp_dir
        frame_cp = ckpt.scan_checkpoint(d, "frame_0")
        unet_cp = ckpt.scan_checkpoint(d, "unet_0")
        hist_cp = ckpt.scan_checkpoint(d, "history_0")
        if frame_cp and unet_cp:
            frame = ckpt.load_checkpoint(frame_cp, module_tree(self.net_frame))
            unet = ckpt.load_checkpoint(unet_cp, module_tree(self.net_unet))
            self.net_frame.load_state_dict(visual_params_from_flax(frame),
                                           strict=True)
            self.net_unet.load_state_dict(unet_params_from_flax(unet),
                                          strict=True)
            self.state = self._init_fn()
            if hist_cp:
                self.history = ckpt.load_history(hist_cp)
                self.start_epoch = int(self.history.get("epoch", 0)) + 1
            print(f"Resumed from {frame_cp} / {unet_cp} "
                  f"at epoch {self.start_epoch}")

    # ------------------------------------------------------------------

    def fit(self, loader_train, loader_val, generator=None):
        """Epochs ``start_epoch .. num_epoch - 1``; the step's draws from
        ``generator``, by default one on the device seeded by ``--seed``."""
        args = self.args
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(args.seed)
        for epoch in range(self.start_epoch, args.num_epoch):
            loader_train.set_epoch(epoch)
            train_loss = self.train_epoch(loader_train, epoch, generator)
            self.history["train_loss"].append(train_loss)
            self.history["epoch"] = epoch
            if epoch % args.eval_epoch == 0:
                mel_l2 = self.evaluate(loader_val, epoch)
                self.history["val_mel_l2"].append(mel_l2)
                self.stabilizer.validation_step(mel_l2)
                self.save_checkpoints(epoch, mel_l2)
        self.writer.close()


@full_precision()
def dump_clip_mels(args, sampler: Stage1Sampler, dataset, out_left: str,
                   out_right: str, features_fn=None, generator=None,
                   max_batch: int = 32):
    """Generate a clip's L/R ln-mels and save the stage-2 ``.npy`` pair as
    ``{video_id}.npy`` in ``out_left`` / ``out_right``; returns (2, M, T).

    ``dataset``: ``full_mel`` (M, T), ``starts`` (window offsets),
    ``rows[0]["video_id"]``, ``len`` and ``[i]`` (one window's item).
    ``features_fn(item)`` -> (512,) conditioning of one window, run under
    ``torch.inference_mode``; None means zeros (the unconditional branch).
    ``args.crop_frames`` is the edge crop; the windows go through the
    sampler ``max_batch`` at a time."""
    os.makedirs(out_left, exist_ok=True)
    os.makedirs(out_right, exist_ok=True)
    if features_fn is None:
        feats = np.zeros((len(dataset), 512), np.float32)
    else:
        with torch.inference_mode():
            feats = torch.stack([
                torch.as_tensor(features_fn(dataset[i])).float().cpu()
                for i in range(len(dataset))]).numpy()
    starts = dataset.starts
    mel = generate_clip(
        sampler, dataset.full_mel[None], feats,
        stride=starts[1] - starts[0] if len(starts) > 1 else 40,
        crop_frames=args.crop_frames, generator=generator,
        max_batch=max_batch)
    base = dataset.rows[0]["video_id"]
    np.save(os.path.join(out_left, base + ".npy"), mel[0])
    np.save(os.path.join(out_right, base + ".npy"), mel[1])
    return mel
