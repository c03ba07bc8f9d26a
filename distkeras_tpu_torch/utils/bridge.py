"""Weights across frameworks: a flax ``CausalLM``, ``ResNet``, ``MLP`` or
``CIFARConvNet`` param tree <-> the port's ``state_dict``.

The flax side is a nested mapping of numpy arrays (convert a JAX tree
with ``jax.tree.map(np.asarray, params)`` first; this module imports no
JAX). The rules:

- Dense ``kernel [in, out]`` <-> ``Linear.weight [out, in]``, ``bias`` as is;
- conv ``kernel [kh, kw, in, out]`` (HWIO) <-> ``weight [out, in, kh, kw]``
  (OIHW), for ``nn.Conv`` and ``ScaledWSConv`` alike; ``gain`` as is;
- ``tok_embed/embedding`` <-> ``tok_embed.weight``; ``pos_embed`` as is;
- LayerNorm and GroupNorm ``scale``/``bias`` <-> ``weight``/``bias``;
- CausalLM: ``layer_{i}/{ln1, attn/{qkv, out}, ln2, mlp/{fc1, fc2}}`` <->
  ``layers.{i}.<same path with dots>``; ``ln_final``, ``lm_head``;
- ResNet: module names are kept (``conv_stem``, ``norm_stem``,
  ``stage{i}_block{j}/{conv1, norm1, ..., proj, norm_proj}``, ``head``);
- MLP (``dense_{i}``, ``head``) and CIFARConvNet (``conv_{i}a``,
  ``conv_{i}b``, ``dense``, ``head``) keep theirs too; the CNN flattens
  its last feature map in NHWC order, so its dense kernel is flax's.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layer_(\d+)$")
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias", "gain": "gain"}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def flax_to_state_dict(params: Mapping) -> dict:
    """flax params of any model above (numpy leaves) -> a
    ``state_dict`` of float32 CPU tensors for the port's model
    (``load_state_dict`` casts to each parameter's dtype and device)."""
    out = {}
    for path, leaf in _flatten(params):
        arr = np.array(leaf, np.float32)  # a writable copy
        if path == ("pos_embed",):
            out["pos_embed"] = torch.from_numpy(arr)
            continue
        *mods, leaf_name = path
        m = _LAYER.match(mods[0])
        mods = ["layers", m.group(1)] + mods[1:] if m else mods
        if leaf_name == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        out[".".join(mods + [_LEAF[leaf_name]])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def state_dict_to_flax(state_dict: Mapping, shapes_only: bool = False
                       ) -> dict:
    """Inverse of :func:`flax_to_state_dict`: a nested dict of float32
    numpy arrays in the flax layout. ``shapes_only`` gives read-only
    zero-stride arrays of the same shapes instead, copying no data (a
    wire codec's template: only shapes and dtypes are read)."""
    tree: dict = {}
    for name, tensor in state_dict.items():
        if shapes_only:
            arr = np.broadcast_to(np.float32(0), tuple(tensor.shape))
        else:
            arr = tensor.detach().to("cpu", torch.float32).numpy()
        if name == "pos_embed":
            tree["pos_embed"] = arr if shapes_only else arr.copy()
            continue
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer_{parts[1]}"] + parts[2:]
        *mods, leaf = parts
        if leaf in ("bias", "gain"):
            key = leaf
        elif arr.ndim == 1:  # LayerNorm / GroupNorm
            key = "scale"
        elif arr.ndim == 4:  # conv, OIHW -> HWIO
            key, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif mods[-1] == "tok_embed":
            key = "embedding"
        else:  # Dense
            key, arr = "kernel", arr.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[key] = arr if shapes_only else np.ascontiguousarray(arr)
    return tree


def load_flax_params(model: torch.nn.Module, params: Mapping):
    """Copy flax params (numpy leaves) into ``model``, strictly: every
    parameter must be covered and no name may be left over."""
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model
