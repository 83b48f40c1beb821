"""What the ranks of ``test_torch_parallel_dist.py`` run: four gloo processes,
spawned once, each importing only torch, numpy and the port (a spawned child
imports this module again, so it imports neither JAX nor pytest fixtures).

The same functions make the one-process references in the parent: every
case takes ``mesh=None`` for the unmeshed run."""

import csv
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.utils import parametrize

from diffbinaural_tpu_torch.core.config import UnetConfig, VocoderConfig
from diffbinaural_tpu_torch.losses import MultiScaleMelSpectrogramLoss
from diffbinaural_tpu_torch.models import (build_unet, init_discriminator,
                                           init_parameters)
from diffbinaural_tpu_torch.models import discriminators as td
from diffbinaural_tpu_torch.models.bigvgan import BigVGAN
from diffbinaural_tpu_torch.parallel import (make_mesh, shard_batch,
                                             shard_vocoder_params)
from diffbinaural_tpu_torch.parallel.mesh import (MODEL, all_gather_rows,
                                                  gathered_state_dict,
                                                  sharded_parameters)
from diffbinaural_tpu_torch.signal import mel_spectrogram
from diffbinaural_tpu_torch.train import (make_stage1_train_step,
                                          make_stage2_train_step)

WORLD = 4
TIMEOUT = datetime.timedelta(seconds=120)

# stage 1: the tiny UNet on a global batch of 4 windows of 16 x 16
S1_BATCH, S1_SIZE, S1_DIM, S1_SEED, S1_STEPS, S1_LR = 4, 16, 8, 3, 2, 1e-4
# stage 2: the tiny generator of the stage-2 tests, a two-period MPD and a
# one-scale CQTD, a global batch of 2; CLIP below the pre-clip norm
TINY_VOCODER = dict(num_mels=8, upsample_rates=(4, 2),
                    upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
                    resblock_kernel_sizes=(3, 7),
                    resblock_dilation_sizes=((1, 3), (1, 3)))
S2_BATCH, S2_FRAMES, S2_HOP, S2_LR, S2_CLIP = 2, 32, 8, 5e-5, 2.0
MPD = dict(periods=(2, 3), channel_mult=0.125)
CQTD = dict(sampling_rate=22050, hop_lengths=(256,), n_octaves=(9,),
            bins_per_octaves=(2,), filters=8)
MSL = dict(n_mels=(5, 10), window_lengths=(32, 64))
# the stage-1 trainer's tiny world and models (test_torch_cli_train.py's)
SR, TRAIN_M = 22050, 16
TINY_CLIP = dict(image_size=224, patch_size=112, width=32, layers=1, heads=2)


# ------------------------------------------------------------------ inputs


def stage1_batch():
    rng = np.random.default_rng(10)
    b, s = S1_BATCH, S1_SIZE
    return {"mono_mel": rng.standard_normal((b, 1, s, s)).astype(np.float32)
            - 5.0,
            "binaural_mel": rng.standard_normal((b, 2, s, s)).astype(
                np.float32) - 5.0,
            "feat": rng.standard_normal((b, 512)).astype(np.float32)}


def stage2_batch():
    rng = np.random.default_rng(20)
    return {"mel": (rng.standard_normal((S2_BATCH, 8, S2_FRAMES)) - 1.0
                    ).astype(np.float32),
            "audio": (0.3 * rng.standard_normal(
                (S2_BATCH, S2_FRAMES * S2_HOP))).astype(np.float32),
            "mel_loss": np.zeros((S2_BATCH, 8, S2_FRAMES), np.float32)}


def write_stage1_world(root):
    """Two 1 s RealBinaural clips (mono + binaural wavs) with train / val
    lists."""
    from diffbinaural_tpu_torch.data.audio_io import save_wav

    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    for sub in ("processed/mono_audios_22050Hz",
                "processed/binaural_audios_22050Hz", "splits"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for vid in ("a", "b"):
        x = (0.3 * np.sin(2 * np.pi * 440 * t)
             + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
        save_wav(os.path.join(root, f"processed/mono_audios_22050Hz/{vid}.wav"),
                 x, SR)
        save_wav(os.path.join(
            root, f"processed/binaural_audios_22050Hz/{vid}.wav"),
            np.stack([x, 0.8 * x]), SR)
    for name in ("train", "val"):
        with open(os.path.join(root, f"splits/{name}.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["video_id", "start_time", "end_time", "action_label"])
            w.writerow(["a", "0.0", "1.0", "x"])
            w.writerow(["b", "0.0", "1.0", "x"])


def trainer_argv(world, ckpt_dir):
    return ["--id", "tiny", "--arch_frame", "clip_pos2d", "--ckpt",
            str(ckpt_dir), "--list_train", os.path.join(world, "splits",
                                                         "train.csv"),
            "--list_val", os.path.join(world, "splits", "val.csv"),
            "--data_root", str(world), "--batch_size_per_gpu", "2",
            "--workers", "1", "--num_frames", "1", "--num_mels",
            str(TRAIN_M), "--num_epoch", "1"]


def tiny_stage1_patches():
    """(object, attribute, value) that shrink the stage-1 CLIs' models as
    ``test_torch_cli_train.py`` does: UNet dim 16, the tiny CLIP tower, a
    DDIM of 2 steps over 50; and a summary logger that writes nothing
    (tensorboardX's import and the figures take seconds, and no test reads
    them here)."""
    from diffbinaural_tpu_torch.cli import arguments, common
    from diffbinaural_tpu_torch.core.config import CLIPConfig
    from diffbinaural_tpu_torch.diffusion import GaussianDiffusion
    from diffbinaural_tpu_torch.utils import SummaryLogger

    parse = arguments.ArgParser.parse_train_arguments

    def parse_tiny(self, argv=None):
        args = parse(self, argv)
        args.unet_dim = 16
        args.clip_config = CLIPConfig(**TINY_CLIP)
        return args

    return [(arguments.ArgParser, "parse_train_arguments", parse_tiny),
            (common, "GaussianDiffusion", lambda **kw: GaussianDiffusion(
                **{**kw, "timesteps": 50, "sampling_timesteps": 2})),
            (common, "SummaryLogger", lambda log_dir: SummaryLogger(None))]


# ------------------------------------------------------------------ cases


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def stage1_steps(mesh=None):
    """Two stage-1 steps of the tiny UNet on this rank's block of the global
    batch: losses, grad norms, the last step's gradients, the parameters."""
    unet = build_unet(UnetConfig(dim=S1_DIM), device="cpu", seed=0)
    init_fn, step_fn = make_stage1_train_step(
        unet, lr_unet=S1_LR, device="cpu", mesh=mesh)
    state = init_fn()
    batch = stage1_batch()
    batch = _tensors(batch if mesh is None else shard_batch(batch, mesh))
    gen = torch.Generator().manual_seed(S1_SEED)
    losses, norms = [], []
    for _ in range(S1_STEPS):
        state, m = step_fn(state, batch, generator=gen)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return {"loss": losses, "grad_norm": norms,
            "grads": {n: p.grad.clone() for n, p in unet.named_parameters()},
            "params": {n: p.detach().clone()
                       for n, p in unet.named_parameters()}}


def _randomized(module, seed):
    """Every per-channel vector (biases, snake parameters, weight-norm
    gains) scaled by 1 + 0.1 N(0, 1) and moved by 0.05 N(0, 1), so that the
    channels differ and a misplaced block shows."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() == 1:
                p.mul_(1 + 0.1 * torch.randn(p.shape, generator=gen))
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return module


def _full_grads(module, mesh):
    """{name: gradient of the whole leaf}: a sharded leaf's blocks gathered
    over ``model``."""
    out = {}
    for prefix, m in module.named_modules():
        if "parametrizations" in prefix.split("."):
            continue
        pre = f"{prefix}." if prefix else ""
        for n, p in m._parameters.items():
            if p is not None:
                out[pre + n] = p.grad.clone()
        if parametrize.is_parametrized(m):
            for n in m.parametrizations:
                out[pre + n] = all_gather_rows(
                    m.parametrizations[n].original.grad, mesh, MODEL)
    return out


def stage2_step(mesh=None):
    """One stage-2 D+G step on this rank's block, the generator sharded over
    the mesh's ``model`` axis: metrics, the clipped gradients of every whole
    leaf and the updated parameters."""
    gen = _randomized(init_parameters(BigVGAN(VocoderConfig(**TINY_VOCODER)),
                                      1), 2)
    mpd = init_discriminator(td.MultiPeriodDiscriminator(**MPD), 3)
    mrd = init_discriminator(td.MultiScaleSubbandCQTDiscriminator(**CQTD), 4)
    if mesh is not None:
        shard_vocoder_params(gen, mesh)
    init_fn, step_fn = make_stage2_train_step(
        gen, mpd, mrd, lambda w: mel_spectrogram(w, 32, 8, 22050, 8, 32),
        MultiScaleMelSpectrogramLoss(22050, **MSL), learning_rate=S2_LR,
        clip_grad_norm=S2_CLIP, device="cpu", mesh=mesh)
    state = init_fn()
    batch = stage2_batch()
    batch = _tensors(batch if mesh is None else shard_batch(batch, mesh))
    state, metrics = step_fn(state, batch)
    grads = (_full_grads(gen, mesh) if mesh is not None else
             {n: p.grad.clone() for n, p in gen.named_parameters()})
    for prefix, m in (("mpd.", mpd), ("mrd.", mrd)):
        grads.update({prefix + n: p.grad.clone()
                      for n, p in m.named_parameters()})
    params = {k: v.clone() for k, v in gathered_state_dict(gen).items()}
    for prefix, m in (("mpd.", mpd), ("mrd.", mrd)):
        params.update({prefix + k: v.clone()
                       for k, v in m.state_dict().items()})
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "params": params,
            "sharded": len(sharded_parameters(gen))}


def pipeline_modules(unet_dim, vocoder_config):
    """The tiny UNet (output projection x 0.01, so that the x0 predictions
    are O(1) and not on the clip) and the tiny vocoder (per-channel vectors
    randomized), random weights from fixed seeds."""
    from diffbinaural_tpu_torch.models import unet as tunet

    net = init_parameters(tunet.AudioVisualModel(dim=unet_dim), 7).eval()
    with torch.no_grad():
        net.net_unet.final_conv.weight.mul_(0.01)
    voc = _randomized(init_parameters(BigVGAN(VocoderConfig(
        **vocoder_config)), 8), 9).eval()
    return net, voc


def mesh_pipeline(inputs, mesh):
    """``BinauralPipeline(mesh=)`` with the tiny UNet and the tiny vocoder
    sharded over ``model``, on the injected global x_T."""
    from diffbinaural_tpu_torch.infer import BinauralPipeline

    net, voc = pipeline_modules(inputs["unet_dim"], inputs["vocoder_config"])
    shard_vocoder_params(voc, mesh)
    pipe = BinauralPipeline(net, voc, inputs["frames"], device="cpu",
                            mesh=mesh, **inputs["geometry"])
    wav = pipe(inputs["mono"], inputs["feats"], noise=inputs["noise"])
    return {"wav": wav, "n_slots": pipe.n_slots, "n_batches": pipe.n_batches}


def train_epoch(world, ckpt_dir):
    """``train_realbinaural.main`` for one epoch on the tiny world; the
    paths this process saved."""
    from diffbinaural_tpu_torch.cli import train_realbinaural
    from diffbinaural_tpu_torch.core import checkpoint

    saved = []

    def recording(save):
        def record(path, *args, **kwargs):
            saved.append(os.path.relpath(path, ckpt_dir))
            return save(path, *args, **kwargs)
        return record

    patches = tiny_stage1_patches() + [
        (checkpoint, name, recording(getattr(checkpoint, name)))
        for name in ("save_checkpoint", "save_history")]
    before = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        trainer = train_realbinaural.main(trainer_argv(world, ckpt_dir),
                                          device="cpu")
    finally:
        for obj, name, value in before:
            setattr(obj, name, value)
    return {"saved": saved, "history": trainer.history,
            "step": trainer.state.step}


# ------------------------------------------------------------------ ranks


def run(rank, workdir):
    """One rank: the 4-rank cases; then ranks 0 and 1 train in a 2-rank
    job while rank 2, out of any job, makes the world-1 trainer run and
    rank 3 the one-process step references.  Results to ``rank{rank}.pt``."""
    torch.set_num_threads(1)
    t0 = time.time()
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store4",
                            rank=rank, world_size=WORLD, timeout=TIMEOUT)
    out = {"stage1": {}}
    for n in (2, 4):
        mesh = make_mesh(n_devices=n, devices="cpu")
        if rank < n:
            out["stage1"][n] = stage1_steps(mesh)
    mesh = make_mesh(model_parallel=2, devices="cpu")
    out["coordinate"] = mesh.get_coordinate()
    out["stage2"] = stage2_step(mesh)
    out["pipeline"] = mesh_pipeline(inputs["pipeline"], mesh)
    dist.destroy_process_group()
    world = inputs["world"]
    if rank < 2:
        dist.init_process_group("gloo", init_method=f"file://{workdir}/store2",
                                rank=rank, world_size=2, timeout=TIMEOUT)
        out["trainer"] = train_epoch(world, os.path.join(workdir,
                                                         "ckpt_world2"))
        dist.destroy_process_group()
    elif rank == 2:
        out["trainer_world1"] = train_epoch(
            world, os.path.join(workdir, "ckpt_world1"))
    else:
        out["reference"] = {"stage1": stage1_steps(), "stage2": stage2_step()}
    out["seconds"] = time.time() - t0
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
