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

The upstream CLIP and torchvision names: ``import_torch_clip_vision``,
``import_torch_clip_text`` and ``import_torch_clip`` map an OpenAI CLIP
state dict (``visual.*``, ``transformer.resblocks.*``; the packed
``in_proj_weight`` split into q / k / v) to the flax tree of the CLIP
towers, ``import_torch_resnet18`` a torchvision resnet18 one to
``ResNet18Trunk``'s (``FrozenBN`` takes the running statistics), and
``graft_resnet18_trunk`` puts the latter into a ``ResnetEncoder`` tree.

Not here: Orbax checkpoints (directories) — reading them needs JAX, so
``load_checkpoint`` names the conversion on the JAX side instead.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
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


# ---------------------------------------------------------------------------
# upstream CLIP and torchvision names
# ---------------------------------------------------------------------------


def _dense(w, b=None) -> Dict[str, np.ndarray]:
    out = {"kernel": w.T.astype(np.float32)}
    if b is not None:
        out["bias"] = b.astype(np.float32)
    return out


def _layer_norm(g, k) -> Dict[str, np.ndarray]:
    return {"scale": g(f"{k}.weight"), "bias": g(f"{k}.bias")}


def _clip_resblocks(g, keys) -> Dict[str, Any]:
    """The residual blocks of one CLIP tower; ``g(key)`` reads a key below
    the tower's prefix, ``keys`` are those keys."""
    n_layers = 1 + max(int(k.split(".")[2]) for k in keys
                       if k.startswith("transformer.resblocks."))
    blocks: Dict[str, Any] = {}
    for i in range(n_layers):
        b = f"transformer.resblocks.{i}"
        in_w, in_b = g(f"{b}.attn.in_proj_weight"), g(f"{b}.attn.in_proj_bias")
        d = in_w.shape[0] // 3
        blocks[f"resblock_{i}"] = {
            "ln_1": _layer_norm(g, f"{b}.ln_1"),
            "ln_2": _layer_norm(g, f"{b}.ln_2"),
            "attn": {
                "q_proj": _dense(in_w[:d], in_b[:d]),
                "k_proj": _dense(in_w[d:2 * d], in_b[d:2 * d]),
                "v_proj": _dense(in_w[2 * d:], in_b[2 * d:]),
                "out_proj": _dense(g(f"{b}.attn.out_proj.weight"),
                                   g(f"{b}.attn.out_proj.bias")),
            },
            "mlp_c_fc": _dense(g(f"{b}.mlp.c_fc.weight"),
                               g(f"{b}.mlp.c_fc.bias")),
            "mlp_c_proj": _dense(g(f"{b}.mlp.c_proj.weight"),
                                 g(f"{b}.mlp.c_proj.bias")),
        }
    return blocks


def import_torch_clip_vision(path_or_sd) -> Dict:
    """OpenAI CLIP ``visual.*`` weights (with or without the ``visual.``
    prefix) -> ``CLIPVisionTransformer``'s flax tree."""
    sd = _load_torch_state_dict(path_or_sd)
    pfx = "visual." if any(k.startswith("visual.") for k in sd) else ""

    def g(k):
        return sd[pfx + k].astype(np.float32)

    keys = [k[len(pfx):] for k in sd if k.startswith(pfx)]
    return {"params": {
        "conv1": {"kernel": g("conv1.weight").transpose(2, 3, 1, 0)},
        "class_embedding": g("class_embedding"),
        "positional_embedding": g("positional_embedding"),
        "ln_pre": _layer_norm(g, "ln_pre"),
        "ln_post": _layer_norm(g, "ln_post"),
        "proj": g("proj"),
        **_clip_resblocks(g, keys),
    }}


def import_torch_clip_text(path_or_sd) -> Dict:
    """OpenAI CLIP text-tower weights (``token_embedding``,
    ``positional_embedding``, ``transformer.resblocks.*``, ``ln_final``,
    ``text_projection``) -> ``CLIPTextTransformer``'s flax tree."""
    sd = _load_torch_state_dict(path_or_sd)

    def g(k):
        return sd[k].astype(np.float32)

    return {"params": {
        "token_embedding": g("token_embedding.weight"),
        "positional_embedding": g("positional_embedding"),
        "ln_final": _layer_norm(g, "ln_final"),
        "text_projection": g("text_projection"),
        **_clip_resblocks(g, list(sd)),
    }}


def import_torch_clip(path_or_sd) -> Dict:
    """A whole OpenAI CLIP checkpoint -> ``CLIPModel``'s flax tree (both
    towers and ``logit_scale``)."""
    sd = _load_torch_state_dict(path_or_sd)
    text_sd = {k: v for k, v in sd.items() if not k.startswith("visual.")}
    return {"params": {
        "visual": import_torch_clip_vision(sd)["params"],
        "text": import_torch_clip_text(text_sd)["params"],
        "logit_scale": sd["logit_scale"].astype(np.float32),
    }}


def import_torch_resnet18(path_or_sd) -> Dict:
    """A torchvision resnet18 state dict -> ``ResNet18Trunk``'s flax tree:
    conv (out, in, kh, kw) -> (kh, kw, in, out), BatchNorm -> ``FrozenBN``'s
    (scale, bias, mean, var) from the running statistics; ``layer{1..4}.
    {0,1}`` -> ``block_{0..7}``; the ``fc`` head is dropped."""
    sd = _load_torch_state_dict(path_or_sd)

    def conv(k):
        return {"kernel": sd[f"{k}.weight"].transpose(2, 3, 1, 0).astype(
            np.float32)}

    def bn(k):
        return {"scale": sd[f"{k}.weight"].astype(np.float32),
                "bias": sd[f"{k}.bias"].astype(np.float32),
                "mean": sd[f"{k}.running_mean"].astype(np.float32),
                "var": sd[f"{k}.running_var"].astype(np.float32)}

    params: Dict[str, Any] = {"conv1": conv("conv1"), "bn1": bn("bn1")}
    for layer in range(1, 5):
        for b in range(2):
            src = f"layer{layer}.{b}"
            blk = {"conv1": conv(f"{src}.conv1"), "bn1": bn(f"{src}.bn1"),
                   "conv2": conv(f"{src}.conv2"), "bn2": bn(f"{src}.bn2")}
            if f"{src}.downsample.0.weight" in sd:
                blk["down_conv"] = conv(f"{src}.downsample.0")
                blk["down_bn"] = bn(f"{src}.downsample.1")
            params[f"block_{(layer - 1) * 2 + b}"] = blk
    return {"params": params}


def is_torchvision_resnet18_sd(path_or_sd) -> bool:
    """Does this torch checkpoint hold torchvision resnet18 weights (and
    not one of the trainers' frame-encoder checkpoints)?  False for a file
    ``torch.load`` cannot read as a state dict."""
    try:
        sd = _load_torch_state_dict(path_or_sd)
    except (OSError, RuntimeError, AttributeError, pickle.UnpicklingError):
        return False
    return "layer1.0.conv1.weight" in sd and "conv1.weight" in sd


def graft_resnet18_trunk(frame_variables: Dict, path_or_sd) -> Dict:
    """A copy of a ``ResnetEncoder`` variables tree with torchvision's
    weights at its ``features`` trunk; the transformer is left as it is."""
    out = dict(frame_variables)
    out["params"] = dict(frame_variables["params"])
    out["params"]["features"] = import_torch_resnet18(path_or_sd)["params"]
    return out
