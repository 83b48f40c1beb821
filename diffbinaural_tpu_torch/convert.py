"""Carry the JAX package's parameter trees over to the port.

The functions take a flax parameter tree as nested dicts of **numpy**
arrays (``jax.tree_util.tree_map(np.asarray, params)`` on the JAX side —
this module never sees JAX) and return a ``state_dict`` that loads into the
port's module with ``strict=True``.  The port's sub-modules carry the flax
names, so the conversion is one walk of the tree plus the layout changes:

  * flax ``Dense`` kernel (in, out)            -> ``weight`` (out, in)
  * flax ``Conv`` / WSConv kernel (kh, kw, in, out) -> ``weight`` (out, in, kh, kw)
  * flax ``GroupNorm`` scale / bias            -> ``weight`` / ``bias``
  * ``WNConv1d`` v (k, in, out)                -> v (out, in, k)
  * ``WNConvTranspose1d`` v (k, out, in)       -> v (in, out, k)
  * ``WNConv2d`` v (kh, kw, in, out)           -> v (out, in, kh, kw)
  * everything else (g, b, alpha, beta, LayerNorm g) unchanged.

``tree_to_flax`` goes the other way for any of the port's models —
parameters, or gradients keyed like them, back to a flax-shaped tree of
numpy arrays — so that a train step of the port can be compared with the
JAX one leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _unwrap(tree: Mapping) -> Mapping:
    """Accept the tree with or without the top-level ``params`` collection."""
    return tree["params"] if set(tree.keys()) == {"params"} else tree


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _leaf(name: str, value: np.ndarray):
    """(port's parameter name, array in the port's layout) of one leaf."""
    value = np.asarray(value)
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {value.ndim}")
    if name == "scale":
        return "weight", value
    if name == "v":
        if value.ndim == 4:  # the 2-D weight-normed conv
            return "v", value.transpose(3, 2, 0, 1)
        # both 1-D weight-normed layouts reverse their three axes
        return "v", value.transpose(2, 1, 0)
    return name, value


def _walk(node: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for key, child in node.items():
        if isinstance(child, Mapping):
            _walk(child, f"{prefix}{key}.", out)
        else:
            name, value = _leaf(key, child)
            out[prefix + name] = _tensor(value)


def _state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _walk(_unwrap(tree), "", out)
    return out


def unet_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Parameters of the JAX ``AudioVisualModel`` (or of a bare ``Unet``, or
    of any of their sub-modules) -> state_dict of the port's counterpart."""
    return _state_dict(tree)


def bigvgan_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Parameters of the JAX ``BigVGAN`` (or ``BinauralBigVGAN``, whose tree
    has a ``generator`` level, or of any sub-module) -> state_dict of the
    port's counterpart."""
    return _state_dict(tree)


def discriminator_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Parameters of a JAX discriminator (multi-period, multi-resolution,
    multi-band, sub-band CQT, combined, or any sub-module) -> state_dict of
    the port's counterpart."""
    return _state_dict(tree)


def _leaf_to_flax(name: str, value: np.ndarray):
    """Inverse of :func:`_leaf`."""
    if name == "weight":
        if value.ndim == 2:
            return "kernel", value.T
        if value.ndim == 4:
            return "kernel", value.transpose(2, 3, 1, 0)
        if value.ndim == 1:
            return "scale", value
        raise ValueError(f"unexpected weight rank {value.ndim}")
    if name == "v":
        if value.ndim == 4:
            return "v", value.transpose(2, 3, 1, 0)
        return "v", value.transpose(2, 1, 0)
    return name, value


def tree_to_flax(named: Mapping[str, torch.Tensor]) -> Dict:
    """``state_dict``-shaped tensors of one of the port's models (its
    parameters, or their gradients under the same names) -> the flax-shaped
    nested dict of numpy arrays, with the layout changes of the
    ``*_params_from_flax`` functions undone.  The result has no top-level
    ``params`` level."""
    tree: Dict = {}
    for key, tensor in named.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        name, value = _leaf_to_flax(
            leaf, tensor.detach().cpu().float().numpy())
        node[name] = np.ascontiguousarray(value)
    return tree
