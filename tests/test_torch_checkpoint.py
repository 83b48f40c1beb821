"""The port's checkpoint I/O against the JAX package: its msgpack encoder
writes flax's bytes, files written by either side load on the other leaf
for leaf, and the upstream BigVGAN name map equals the JAX functions'."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_serialization

from diffbinaural_tpu.core import checkpoint as jax_ckpt
from diffbinaural_tpu.core.config import VocoderConfig as JaxVocoderConfig
from diffbinaural_tpu.models import AudioVisualModel as JaxAudioVisualModel
from diffbinaural_tpu.models.bigvgan import BigVGAN as JaxBigVGAN
from diffbinaural_tpu_torch.convert import bigvgan_params_from_flax
from diffbinaural_tpu_torch.core import checkpoint, serialization
from diffbinaural_tpu_torch.core.config import VocoderConfig
from diffbinaural_tpu_torch.models import BigVGAN

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import TINY_VOCODER, random_params, to_numpy_tree


def _unet_tree():
    x0 = jnp.zeros((1, 2, 16, 80))
    cond0 = (jnp.zeros((1, 1, 16, 80)), jnp.zeros((1, 512)), x0)
    return to_numpy_tree(random_params(
        JaxAudioVisualModel(dim=16), np.random.default_rng(0), x0,
        jnp.zeros((1,), jnp.int32), cond0))


def _generator_tree():
    return to_numpy_tree(random_params(
        JaxBigVGAN(JaxVocoderConfig(**TINY_VOCODER)), np.random.default_rng(1),
        jnp.zeros((1, 8, 16))))


def _do_tree():
    """A ``do_%08d``-style state: nested dicts, Python ints, a 0-d array,
    numpy scalars, None and a list."""
    rng = np.random.default_rng(2)
    return {
        "mpd": {"params": {"conv_0": {
            "kernel": rng.standard_normal((5, 1, 1, 32)).astype(np.float32),
            "bias": np.zeros((32,), np.float32)}}},
        "optim_d": {"count": np.asarray(17, np.int32),
                    "mu": {"w": rng.standard_normal((3, 3)).astype(np.float32)},
                    "nu": None},
        "steps": 123456, "epoch": 3, "neg": -70000, "lr": 2e-4,
        "flags": [True, False], "scale": np.float32(0.5),
        "many": {str(i): i * 300 for i in range(20)},
    }


TREES = {"unet": _unet_tree, "generator": _generator_tree, "do": _do_tree}


def _assert_trees_equal(got, want, port_read=True):
    """Equal leaf for leaf; arrays the port read must be writable."""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
        want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert type(g) is type(w), (type(g), type(w))
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            assert g.flags.writeable or not port_read
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("name", sorted(TREES))
def test_encoder_writes_flax_bytes(name):
    tree = TREES[name]()
    assert serialization.to_bytes(tree) == flax_serialization.to_bytes(tree)


@pytest.mark.parametrize("name", sorted(TREES))
def test_files_load_on_the_other_side(tmp_path, name):
    tree = TREES[name]()
    jax_ckpt.save_checkpoint(str(tmp_path / "jax_file"), tree)
    checkpoint.save_checkpoint(str(tmp_path / "port_file"), tree)
    assert (tmp_path / "jax_file").read_bytes() == (
        tmp_path / "port_file").read_bytes()
    assert sorted(os.listdir(tmp_path)) == ["jax_file", "port_file"]
    want = flax_serialization.msgpack_restore(
        (tmp_path / "jax_file").read_bytes())
    _assert_trees_equal(checkpoint.load_checkpoint(str(tmp_path / "jax_file")),
                        want)
    _assert_trees_equal(jax_ckpt.load_checkpoint(str(tmp_path / "port_file")),
                        want, port_read=False)


def test_load_into_a_target(tmp_path):
    tree = _do_tree()
    path = str(tmp_path / "do_00000001")
    jax_ckpt.save_checkpoint(path, tree)
    target = {k: tree[k] for k in sorted(tree)}
    _assert_trees_equal(checkpoint.load_checkpoint(path, target),
                        jax_ckpt.load_checkpoint(path, target))
    with pytest.raises(ValueError, match="do not match"):
        checkpoint.load_checkpoint(path, {"steps": 0})


def test_chunked_and_bfloat16_leaves(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 96)
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 96)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((10, 7)).astype(np.float32)  # 280 bytes: 3 chunks
    bits = rng.integers(-2**15, 2**15, (9, 11), dtype=np.int16)
    bf16_jax = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
    bf16_port = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    small = np.arange(4, dtype=np.float32)

    port_bytes = serialization.to_bytes({"w": w, "h": bf16_port, "s": small})
    flax_bytes = flax_serialization.to_bytes(
        {"w": w, "h": bf16_jax, "s": small})
    assert port_bytes == flax_bytes
    assert b"__msgpack_chunked_array__" in port_bytes

    got = serialization.msgpack_restore(flax_bytes)
    np.testing.assert_array_equal(got["w"], w)
    assert got["h"].dtype == torch.bfloat16 and got["h"].shape == (9, 11)
    np.testing.assert_array_equal(got["h"].view(torch.int16).numpy(), bits)
    back = flax_serialization.msgpack_restore(port_bytes)
    assert back["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(back["h"]),
                                                jnp.int16)), bits)


def test_malformed_bytes_raise():
    """Every cut of a valid document, trailing bytes, an unused type byte
    and a zip archive (what ``torch.save`` writes) raise DecodeError."""
    good = serialization.to_bytes({"a": np.ones(3, np.float32), "n": 300,
                                   "s": "x", "b": np.float32(1)})
    bad = [good[:n] for n in range(len(good))]
    for b in bad + [good + b"\x00", b"\xc1", b"PK\x03\x04"]:
        with pytest.raises(serialization.DecodeError):
            serialization.msgpack_restore(b)


def test_scan_checkpoint_and_history_equal_jax(tmp_path):
    d = str(tmp_path)
    assert checkpoint.scan_checkpoint(d, "g_") is None
    for name in ("g_00000001", "g_00000002", "g_00000003.tmp", "do_00000009"):
        (tmp_path / name).write_bytes(b"")
    os.mkdir(tmp_path / "g_00000004.ocp-tmp")
    os.mkdir(tmp_path / "g_00000005.ocp-old")
    for prefix in ("g_", "do_", "unet_"):
        assert checkpoint.scan_checkpoint(d, prefix) == \
            jax_ckpt.scan_checkpoint(d, prefix)
    assert checkpoint.scan_checkpoint(d, "g_").endswith("g_00000002")
    (tmp_path / "bigvgan_generator.pt").write_bytes(b"")
    assert checkpoint.scan_checkpoint(
        d, "unet_", renamed_file="bigvgan_generator.pt") == \
        jax_ckpt.scan_checkpoint(d, "unet_", renamed_file="bigvgan_generator.pt")

    history = {"step": [1, 2], "loss": [0.5, 0.25]}
    checkpoint.save_history(str(tmp_path / "h" / "history_000002"), history)
    assert jax_ckpt.load_history(str(tmp_path / "h" / "history_000002")) == \
        history == checkpoint.load_history(str(tmp_path / "h" / "history_000002"))


def test_orbax_is_refused(tmp_path):
    os.mkdir(tmp_path / "unet_best")
    with pytest.raises(ValueError, match="backend='msgpack'"):
        checkpoint.load_checkpoint(str(tmp_path / "unet_best"))
    os.mkdir(tmp_path / "g_00000001.ocp-old")  # an interrupted Orbax swap
    with pytest.raises(ValueError, match="Orbax"):
        checkpoint.load_checkpoint(str(tmp_path / "g_00000001"))
    with pytest.raises(ValueError, match="msgpack checkpoints only"):
        checkpoint.save_checkpoint(str(tmp_path / "x"), {}, backend="orbax")
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        checkpoint.save_checkpoint(str(tmp_path / "x"), {}, backend="npz")


@pytest.mark.parametrize("beta", [True, False])
def test_upstream_names_equal_jax(beta):
    cfg = dict(TINY_VOCODER, activation="snakebeta" if beta else "snake")
    tree = to_numpy_tree(random_params(
        JaxBigVGAN(JaxVocoderConfig(**cfg)), np.random.default_rng(4),
        jnp.zeros((1, 8, 16))))
    jcfg, tcfg = JaxVocoderConfig(**cfg), VocoderConfig(**cfg)
    want_sd = jax_ckpt.export_bigvgan_to_torch(tree, jcfg)
    got_sd = checkpoint.export_bigvgan_to_torch(tree, tcfg)
    assert list(got_sd) == list(want_sd)
    for k in want_sd:
        np.testing.assert_array_equal(got_sd[k], want_sd[k])
    assert any(k.endswith(".weight_v") for k in got_sd)
    assert any(k.endswith("act.beta") for k in got_sd) == beta

    torch_sd = {k: torch.from_numpy(np.array(v))
                for k, v in got_sd.items()}
    got = checkpoint.import_torch_bigvgan(torch_sd, tcfg)
    _assert_trees_equal(got, jax_ckpt.import_torch_bigvgan(torch_sd, jcfg))
    _assert_trees_equal(got, tree)
    model = BigVGAN(tcfg)
    model.load_state_dict(bigvgan_params_from_flax(got), strict=True)


def test_pretrained_directory_both_branches(tmp_path):
    tree = _generator_tree()
    tcfg = VocoderConfig(**TINY_VOCODER)
    checkpoint.save_pretrained(str(tmp_path / "msgpack"), tree, tcfg)
    params, cfg = checkpoint.from_pretrained(str(tmp_path / "msgpack"))
    _assert_trees_equal(params, tree)
    want_params, want_cfg = jax_ckpt.from_pretrained(str(tmp_path / "msgpack"))
    _assert_trees_equal(want_params, params, port_read=False)
    assert cfg == want_cfg
    assert VocoderConfig.from_attrdict(cfg) == tcfg

    # the upstream layout: a torch state dict under the same file name
    up = tmp_path / "upstream"
    up.mkdir()
    (up / "config.json").write_text(json.dumps(cfg))
    torch.save({"generator": {
        k: torch.from_numpy(np.array(v))
        for k, v in checkpoint.export_bigvgan_to_torch(tree, tcfg).items()}},
        up / "bigvgan_generator.pt")
    params, _ = checkpoint.from_pretrained(str(up))
    _assert_trees_equal(params, {"params": tree["params"]})
