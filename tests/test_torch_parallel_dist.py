"""The port's ``parallel/`` across processes: four gloo ranks spawned once for
the module (``_torch_parallel_worker.run``), every case inside that spawn,
each against a one-process reference.

  * two stage-1 steps of a tiny UNet data-parallel on (2 x 1) and (4 x 1)
    meshes against the 1-rank step on the full batch;
  * one stage-2 step with the generator channel-sharded on a (2 x 2) mesh
    against the 1-rank step;
  * ``BinauralPipeline(mesh=)`` on a (2 x 2) mesh with a sharded tiny
    vocoder and converted weights against the JAX package's
    ``BinauralPipeline(mesh=make_mesh(4, 2, cpu devices))``;
  * a world-2 ``Stage1Trainer`` epoch (ranks 0 and 1 in a second job)
    against the world-1 run: rank 0 alone writes the checkpoint.

Tolerances, float32: a batch split over ranks sums its means in another
order (losses and norms within 1e-5 relative, gradients within 1e-4 of
each leaf's scale plus 1e-5 of the largest); one Adam step moves a
parameter by about lr either way, so a gradient that is zero up to
rounding may flip a parameter's step (parameters within 2 lr)."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from diffbinaural_tpu.core.config import VocoderConfig as JaxVocoderConfig
from diffbinaural_tpu.infer import pipeline as jax_pipeline
from diffbinaural_tpu.models import AudioVisualModel as JaxAudioVisualModel
from diffbinaural_tpu.models.bigvgan import BigVGAN as JaxBigVGAN
from diffbinaural_tpu.parallel import make_mesh as jax_make_mesh
from diffbinaural_tpu.parallel import replicate as jax_replicate
from diffbinaural_tpu.parallel import \
    shard_vocoder_params as jax_shard_vocoder_params
from diffbinaural_tpu_torch.convert import tree_to_flax
from diffbinaural_tpu_torch.core import checkpoint as ckpt

import _torch_parallel_worker as worker
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

M, WINDOW, STRIDE, CROP, FRAMES, UNET_DIM, DDIM = 16, 16, 8, 2, 48, 8, 2
VOC = dict(worker.TINY_VOCODER, num_mels=M)
SPAWN_TIMEOUT_S = 240
LOSS_REL, GRAD_REL, GRAD_FLOOR = 1e-5, 1e-4, 1e-5


def _pipeline_inputs():
    """The tiny UNet and vocoder of the ranks, their weights converted to
    the JAX trees; a clip of 48 frames (5 windows of 16, 6 slots on 2 data
    ranks); x_T as the JAX mesh pipeline draws it (one group:
    fold_in(key, 0), then split)."""
    rng = np.random.default_rng(0)
    net, voc = worker.pipeline_modules(UNET_DIM, VOC)
    trees = [jax.tree_util.tree_map(jnp.asarray, {"params": tree_to_flax(
        m.state_dict())}) for m in (net, voc)]
    mono = (rng.standard_normal((1, M, FRAMES)) * 2.0 - 5.0).astype(np.float32)
    feats = rng.standard_normal((5, 512)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    rng_init, _ = jax.random.split(jax.random.fold_in(key, 0))
    noise = np.asarray(jax.random.normal(rng_init, (6, 2, M, WINDOW)))[None]
    geometry = dict(num_mels=M, window=WINDOW, stride=STRIDE,
                    crop_frames=CROP, sampling_timesteps=DDIM)
    inputs = dict(unet_dim=UNET_DIM, vocoder_config=VOC, frames=FRAMES,
                  geometry=geometry, mono=mono, feats=feats,
                  noise=np.array(noise))
    return inputs, trees + [key]


def _jax_mesh_wav(inputs, jax_side):
    up, vp, key = jax_side
    junet = JaxAudioVisualModel(dim=UNET_DIM)
    jvoc = JaxBigVGAN(JaxVocoderConfig(**VOC))
    mesh = jax_make_mesh(4, 2, devices=jax.devices("cpu"))
    pipe = jax_pipeline.BinauralPipeline(
        lambda p, x, tt, c: junet.apply(p, x, tt, c),
        lambda p, mel: jvoc.apply(p, mel), FRAMES, fuse_vocoder=False,
        mesh=mesh, **inputs["geometry"])
    assert (pipe.n_slots, pipe.n_batches) == (6, 1)
    return np.asarray(pipe(jax.device_put(up, jax_replicate(mesh)),
                           jax_shard_vocoder_params(vp, mesh), inputs["mono"],
                           inputs["feats"], key))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the four ranks and, while they run, the JAX mesh pipeline in
    this process."""
    workdir = str(tmp_path_factory.mktemp("parallel_dist"))
    world = os.path.join(workdir, "world")
    worker.write_stage1_world(world)
    inputs, jax_side = _pipeline_inputs()
    torch.save({"pipeline": inputs, "world": world},
               os.path.join(workdir, "inputs.pt"))
    ctx = mp.start_processes(worker.run, args=(workdir,), nprocs=worker.WORLD,
                             join=False, start_method="spawn")
    try:
        jax_wav = _jax_mesh_wav(inputs, jax_side)
        deadline = time.time() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=1):
            assert time.time() < deadline, "the gloo ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                        weights_only=False) for r in range(worker.WORLD)]
    ref = dict(ranks[3]["reference"], jax_wav=jax_wav,
               trainer=ranks[2]["trainer_world1"])
    return dict(ref=ref, ranks=ranks, workdir=workdir)


def _close(got, want, what, rel=GRAD_REL):
    """Each tensor within ``rel`` of its own scale plus GRAD_FLOOR of the
    largest one's."""
    assert got.keys() == want.keys(), what
    top = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        torch.testing.assert_close(
            got[name], w, rtol=0, atol=rel * w.abs().max().item()
            + GRAD_FLOOR * top, msg=lambda m: f"{what} {name}: {m}")


@pytest.mark.parametrize("n_data", [2, 4])
def test_stage1_steps_on_a_data_mesh_equal_one_rank(runs, n_data):
    want = runs["ref"]["stage1"]
    outs = [r["stage1"][n_data] for r in runs["ranks"][:n_data]]
    for out in outs:
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=LOSS_REL)
        np.testing.assert_allclose(out["grad_norm"], want["grad_norm"],
                                   rtol=LOSS_REL)
        _close(out["grads"], want["grads"], "stage-1 gradient")
        for name, w in want["params"].items():
            torch.testing.assert_close(out["params"][name], w, rtol=0,
                                       atol=2 * worker.S1_LR * 1.001)
    # the ranks hold the same replicas, bit for bit
    for out in outs[1:]:
        for name, p in outs[0]["params"].items():
            assert torch.equal(out["params"][name], p), name
    assert all(n_data not in r["stage1"] for r in runs["ranks"][n_data:])


def test_stage2_step_with_a_sharded_generator_equals_one_rank(runs):
    want = runs["ref"]["stage2"]
    assert [r["coordinate"] for r in runs["ranks"]] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in runs["ranks"]:
        out = r["stage2"]
        assert out["sharded"]  # the rule sharded leaves at model size 2
        for name, v in want["metrics"].items():
            np.testing.assert_allclose(out["metrics"][name], v,
                                       rtol=LOSS_REL, err_msg=name)
        assert want["metrics"]["grad_norm_g"] > worker.S2_CLIP  # clipped
        _close(out["grads"], want["grads"], "stage-2 gradient")
        assert out["params"].keys() == want["params"].keys()
        for name, w in want["params"].items():
            torch.testing.assert_close(out["params"][name], w, rtol=0,
                                       atol=2 * worker.S2_LR * 1.001)


def test_mesh_pipeline_equals_the_jax_mesh_pipeline(runs):
    want = runs["ref"]["jax_wav"]
    wavs = [r["pipeline"]["wav"] for r in runs["ranks"]]
    assert all((r["pipeline"]["n_slots"], r["pipeline"]["n_batches"])
               == (6, 1) for r in runs["ranks"])
    for wav in wavs[1:]:  # every rank returns the same waveform
        assert torch.equal(wav, wavs[0])
    assert wavs[0].shape == want.shape == (2, FRAMES * 8)
    scale = np.abs(want).max()
    assert scale > 1e-3
    err = np.abs(wavs[0].numpy() - want).max()
    assert err <= 1e-3 * scale, (err, scale)


def test_world2_trainer_writes_once_and_equals_world1(runs):
    one = runs["ref"]["trainer"]
    rank0, rank1 = (r["trainer"] for r in runs["ranks"][:2])
    assert "trainer" not in runs["ranks"][2] and \
        "trainer" not in runs["ranks"][3]
    assert rank1["saved"] == []
    assert sorted(rank0["saved"]) == sorted(one["saved"])
    assert {"tiny/unet_000000", "tiny/frame_000000",
            "tiny/history_000000"} <= set(rank0["saved"])
    assert rank0["step"] == rank1["step"] == one["step"] == 1
    # validation: every rank alike, the world-1 number within tolerance
    assert rank0["history"]["val_mel_l2"] == rank1["history"]["val_mel_l2"]
    np.testing.assert_allclose(rank0["history"]["train_loss"],
                               one["history"]["train_loss"], rtol=LOSS_REL)
    np.testing.assert_allclose(rank0["history"]["val_mel_l2"],
                               one["history"]["val_mel_l2"], rtol=1e-3)
    lr = 1e-3  # ArgParser's --lr_unet, the larger of the two rates
    for name in ("unet_000000", "frame_000000"):
        got = ckpt.load_checkpoint(os.path.join(
            runs["workdir"], "ckpt_world2", "tiny", name))
        want = ckpt.load_checkpoint(os.path.join(
            runs["workdir"], "ckpt_world1", "tiny", name))
        got_l, got_s = jax.tree_util.tree_flatten(got)
        want_l, want_s = jax.tree_util.tree_flatten(want)
        assert got_s == want_s
        for g, w in zip(got_l, want_l):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                       atol=2 * lr * 1.001)
