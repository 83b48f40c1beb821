"""Checkpoints — counterpart of ``diffbinaural_tpu/core/checkpoint.py``.

Reads and writes the files the JAX package's trainers write: flax msgpack,
one file per checkpoint, through the port's own codec
(``core/serialization.py``):

  * stage 1: ``unet_{latest,best}.pth`` and ``unet_%06d`` hold the
    ``AudioVisualModel`` variables, ``history_%06d`` a JSON history;
  * stage 2: ``g_%08d`` = ``{"generator": params}`` and ``do_%08d`` the
    discriminators, optimisers and counters;
  * ``scan_checkpoint``'s prefix glob, with the half-written ``.tmp`` and
    Orbax ``.ocp-*`` files left out; writes go to ``.tmp`` then
    ``os.replace``.

Trees are flax-shaped: nested dicts of numpy arrays, as the JAX functions
take and return them.  ``convert.py`` owns the layouts between them and the
port's ``state_dict``s (``*_params_from_flax``, ``tree_to_flax``).

The upstream BigVGAN names: ``import_torch_bigvgan`` and
``export_bigvgan_to_torch`` map a reference-layout generator state dict
(``weight_v``/``weight_g``, ``ups.i.0``, ``resblocks.k.convs1.m``) to and
from the flax tree; ``save_pretrained`` / ``from_pretrained`` are the
Hub-style directory of ``config.json`` + ``bigvgan_generator.pt``.

Not here: Orbax checkpoints (directories) — reading them needs JAX, so
``load_checkpoint`` names the conversion on the JAX side instead — and the
CLIP / ResNet-18 import shims, which wait for the visual encoders.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import asdict
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import serialization
from .config import VocoderConfig


# ---------------------------------------------------------------------------
# save / load / scan
# ---------------------------------------------------------------------------


def _numpy_tree(tree):
    """The JAX package's ``tree_map(np.asarray, tree)``: dict keys sorted
    as JAX flattens them, every leaf an array (a bfloat16 tensor stays a
    tensor), ``None`` kept."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu()
        return tree if tree.dtype == torch.bfloat16 else tree.numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, pytree: Any, backend: str = "msgpack"):
    """Atomic write of one flax-msgpack file: ``.tmp``, then ``os.replace``.
    The bytes are those the JAX package's ``save_checkpoint`` writes for the
    same tree.  The port writes no Orbax checkpoint."""
    if backend == "orbax":
        raise ValueError("the port writes msgpack checkpoints only: Orbax "
                         "needs JAX")
    if backend != "msgpack":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = serialization.serialize(
        serialization.to_state_dict(_numpy_tree(pytree)))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _is_orbax(path: str) -> bool:
    """A directory, or the pair an interrupted Orbax swap leaves behind."""
    return os.path.isdir(path) or (
        not os.path.exists(path)
        and any(os.path.isdir(path + s) for s in (".ocp-tmp", ".ocp-old")))


def load_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """The tree a msgpack checkpoint holds; with ``target``, its values in
    ``target``'s structure (flax's ``from_bytes``)."""
    if _is_orbax(path):
        raise ValueError(
            f"{path} is an Orbax checkpoint, which the port cannot read "
            "without JAX; convert it with the JAX package: "
            "save_checkpoint(out, load_checkpoint(path), backend='msgpack')")
    with open(path, "rb") as f:
        data = f.read()
    if target is not None:
        return serialization.from_bytes(target, data)
    return serialization.msgpack_restore(data)


def scan_checkpoint(cp_dir: str, prefix: str,
                    renamed_file: Optional[str] = None) -> Optional[str]:
    """Latest checkpoint matching prefix, with the renamed-file fallback
    (e.g. ``bigvgan_generator.pt``)."""
    pattern = os.path.join(cp_dir, prefix + "*")
    cps = [
        p for p in glob.glob(pattern)
        if not p.endswith((".tmp", ".ocp-tmp", ".ocp-old"))
    ]
    if cps:
        return sorted(cps)[-1]
    if renamed_file:
        renamed = os.path.join(cp_dir, renamed_file)
        if os.path.isfile(renamed):
            return renamed
    return None


def save_history(path: str, history: Dict):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(history, f)
    os.replace(tmp, path)


def load_history(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# upstream BigVGAN names
# ---------------------------------------------------------------------------


def _load_torch_state_dict(path_or_sd) -> Dict[str, np.ndarray]:
    """A torch state dict (a file, or a mapping of tensors / arrays) as
    numpy arrays; a file's ``generator`` entry when it has one."""
    if isinstance(path_or_sd, (str, os.PathLike)):
        sd = torch.load(path_or_sd, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "generator" in sd:
            sd = sd["generator"]
        return {k: v.numpy() for k, v in sd.items()}
    return {
        k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
        for k, v in path_or_sd.items()
    }


def import_torch_bigvgan(path_or_sd, config: VocoderConfig) -> Dict:
    """Reference BigVGAN generator state dict -> flax param tree.

    torch weight norm stores weight_v / weight_g; layouts:
      Conv1d        (out, in, k)   g: (out, 1, 1)
      ConvTranspose (in, out, k)   g: (in, 1, 1)
    flax: WNConv1d v (k, in, out), g (out,);
          WNConvTranspose1d v (k, out, in), g (in,).
    """
    sd = _load_torch_state_dict(path_or_sd)
    params: Dict[str, Any] = {}

    def wn(src):
        return {"v": sd[f"{src}.weight_v"].transpose(2, 1, 0),
                "g": sd[f"{src}.weight_g"].reshape(-1)}

    def conv(dst, src, bias=True):
        params[dst] = wn(src)
        if bias and f"{src}.bias" in sd:
            params[dst]["b"] = sd[f"{src}.bias"]

    conv("conv_pre", "conv_pre")
    num_kernels = len(config.resblock_kernel_sizes)
    for i in range(len(config.upsample_rates)):
        params[f"up_{i}"] = dict(wn(f"ups.{i}.0"), b=sd[f"ups.{i}.0.bias"])
        for j in range(num_kernels):
            flat = i * num_kernels + j
            blk: Dict[str, Any] = {}
            n_dil = len(config.resblock_dilation_sizes[j])
            for m in range(n_dil):
                for tname, oname in ((f"convs1.{m}", f"conv1_{m}"),
                                     (f"convs2.{m}", f"conv2_{m}")):
                    src = f"resblocks.{flat}.{tname}"
                    blk[oname] = dict(wn(src), b=sd[f"{src}.bias"])
            for a in range(2 * n_dil):
                act = {"alpha": sd[f"resblocks.{flat}.activations.{a}.act.alpha"]}
                beta = f"resblocks.{flat}.activations.{a}.act.beta"
                if beta in sd:
                    act["beta"] = sd[beta]
                blk[f"act{a}"] = {"act": act}
            params[f"resblock_{i}_{j}"] = blk

    post_act = {"alpha": sd["activation_post.act.alpha"]}
    if "activation_post.act.beta" in sd:
        post_act["beta"] = sd["activation_post.act.beta"]
    params["activation_post"] = {"act": post_act}
    conv("conv_post", "conv_post", bias=config.use_bias_at_final)
    return {"params": params}


def export_bigvgan_to_torch(params: Dict,
                            config: VocoderConfig) -> Dict[str, np.ndarray]:
    """Inverse of ``import_torch_bigvgan``: a reference-layout state dict of
    numpy arrays (wrap them in tensors to ``torch.save``)."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}

    def conv(node, dst, bias=True):
        sd[f"{dst}.weight_v"] = np.asarray(node["v"]).transpose(2, 1, 0)
        sd[f"{dst}.weight_g"] = np.asarray(node["g"]).reshape(-1, 1, 1)
        if bias and "b" in node:
            sd[f"{dst}.bias"] = np.asarray(node["b"])

    def act(node, dst):
        sd[f"{dst}.act.alpha"] = np.asarray(node["act"]["alpha"])
        if "beta" in node["act"]:
            sd[f"{dst}.act.beta"] = np.asarray(node["act"]["beta"])

    conv(p["conv_pre"], "conv_pre")
    num_kernels = len(config.resblock_kernel_sizes)
    for i in range(len(config.upsample_rates)):
        conv(p[f"up_{i}"], f"ups.{i}.0")
        for j in range(num_kernels):
            flat = i * num_kernels + j
            blk = p[f"resblock_{i}_{j}"]
            n_dil = len(config.resblock_dilation_sizes[j])
            for m in range(n_dil):
                conv(blk[f"conv1_{m}"], f"resblocks.{flat}.convs1.{m}")
                conv(blk[f"conv2_{m}"], f"resblocks.{flat}.convs2.{m}")
            for a in range(2 * n_dil):
                act(blk[f"act{a}"], f"resblocks.{flat}.activations.{a}")
    act(p["activation_post"], "activation_post")
    conv(p["conv_post"], "conv_post", bias=config.use_bias_at_final)
    return sd


def save_pretrained(save_directory: str, params: Dict,
                    config: VocoderConfig) -> None:
    """Hub-style local save: ``config.json`` + the generator as the
    msgpack file ``bigvgan_generator.pt`` (``{"generator": params}``)."""
    os.makedirs(save_directory, exist_ok=True)
    cfg = asdict(config) if hasattr(config, "__dataclass_fields__") else dict(
        config)
    with open(os.path.join(save_directory, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    save_checkpoint(os.path.join(save_directory, "bigvgan_generator.pt"),
                    {"generator": params})


def from_pretrained(directory: str):
    """-> (params, config dict); inverse of ``save_pretrained``.  A
    ``bigvgan_generator.pt`` that is not msgpack is read as an upstream
    torch state dict."""
    with open(os.path.join(directory, "config.json")) as f:
        cfg = json.load(f)
    path = os.path.join(directory, "bigvgan_generator.pt")
    try:
        return load_checkpoint(path)["generator"], cfg
    except serialization.DecodeError:
        return import_torch_bigvgan(path, VocoderConfig.from_attrdict(cfg)), cfg
