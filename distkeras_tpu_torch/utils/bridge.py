"""Weights across frameworks: a flax ``CausalLM``, ``ResNet``, ``MLP``,
``CIFARConvNet``, ``BertMLM``, ``ViT`` or ``MoEClassifier`` param tree <->
the port's ``state_dict``.

The flax side is a nested mapping of numpy arrays (convert a JAX tree
with ``jax.tree.map(np.asarray, params)`` first; this module imports no
JAX). The rules:

- Dense ``kernel [in, out]`` <-> ``Linear.weight [out, in]``, ``bias`` as is;
- stacked experts (flax's ``nn.vmap``): ``kernel [E, in, out]`` <->
  ``weight [E, out, in]`` (each expert transposed), ``bias [E, out]`` as is;
- conv ``kernel [kh, kw, in, out]`` (HWIO) <-> ``weight [out, in, kh, kw]``
  (OIHW), for ``nn.Conv``, ``ScaledWSConv`` and ViT's ``patch_embed``
  alike; ``gain`` as is;
- ``tok_embed/embedding`` and ``seg_embed/embedding`` <-> ``.weight``;
  top-level arrays (``pos_embed`` of rank 2 or 3, ViT's ``cls``) as they
  are;
- LayerNorm and GroupNorm ``scale``/``bias`` <-> ``weight``/``bias``;
- ``layer_{i}`` at any depth <-> ``layers.{i}``: CausalLM's
  ``layer_{i}/{ln1, attn/{qkv, out}, ln2, mlp/{fc1, fc2}}`` and the
  encoder's ``encoder/layer_{i}/...`` alike; ``ln_final``, ``lm_head``;
- the JAX package's ``PipelinedLM`` tree ``{"embed": {tok_embed,
  pos_embed}, "blocks": <one DecoderBlock tree, leaves [P, L/P, ...]>,
  "head": {ln_final, lm_head}}`` <-> the port's ``embed.*``,
  ``stages.{s}.{j}.*`` (layer ``s * L/P + j``) and ``head.*``
  (:func:`pipelined_lm_to_state_dict`, :func:`state_dict_to_pipelined_lm`);
  a ``GenericPipeline``'s tuple of per-stage trees goes stage by stage
  through the rules here (:func:`pipeline_stages_to_state_dicts`,
  :func:`state_dicts_to_pipeline_stages`);
- every other module name is kept: ResNet's (``conv_stem``,
  ``norm_stem``, ``stage{i}_block{j}/{conv1, norm1, ..., proj,
  norm_proj}``, ``head``), BERT's (``ln_embed``, ``mlm_dense``,
  ``mlm_ln``, ``mlm_head``), the MoE classifier's (``block{i}/{ln1, attn,
  ln2, moe/{router, experts/{fc1, fc2}}}``, ``head``), the MLP's
  (``dense_{i}``, ``head``) and CIFARConvNet's (``conv_{i}a``,
  ``conv_{i}b``, ``dense``, ``head``); the CNN flattens its last feature
  map in NHWC order, so its dense kernel is flax's.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layer_(\d+)$")
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias", "gain": "gain"}
#: flax kernel -> port weight: Dense, stacked experts, conv (HWIO -> OIHW)
_KERNEL_AXES = {2: (1, 0), 3: (0, 2, 1), 4: (3, 2, 0, 1)}


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
        if len(path) == 1:  # pos_embed, cls
            out[path[0]] = torch.from_numpy(arr)
            continue
        *mods, leaf_name = path
        names = []
        for mod in mods:
            m = _LAYER.match(mod)
            names += ["layers", m.group(1)] if m else [mod]
        if leaf_name == "kernel":
            arr = arr.transpose(_KERNEL_AXES[arr.ndim])
        out[".".join(names + [_LEAF[leaf_name]])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def flax_layout(name: str, ndim: int) -> tuple:
    """``(path, axes)`` of the port parameter ``name`` of rank ``ndim``
    in the flax tree: its path (a tuple of keys, e.g. ``("layer_0",
    "attn", "qkv", "kernel")``) and the permutation that turns the port
    tensor into the flax array (``flax = port.permute(axes)``)."""
    identity = tuple(range(ndim))
    if "." not in name:  # pos_embed, cls
        return (name,), identity
    parts, raw = [], name.split(".")
    while raw:
        part = raw.pop(0)
        parts.append(f"layer_{raw.pop(0)}" if part == "layers" else part)
    *mods, leaf = parts
    if leaf in ("bias", "gain"):
        key, axes = leaf, identity
    elif ndim == 1:  # LayerNorm / GroupNorm
        key, axes = "scale", identity
    elif ndim == 4:  # conv, OIHW -> HWIO
        key, axes = "kernel", (2, 3, 1, 0)
    elif ndim == 3:  # stacked experts, [E, out, in] -> [E, in, out]
        key, axes = "kernel", (0, 2, 1)
    elif mods[-1] in ("tok_embed", "seg_embed"):
        key, axes = "embedding", identity
    else:  # Dense
        key, axes = "kernel", (1, 0)
    return tuple(mods) + (key,), axes


def state_dict_to_flax(state_dict: Mapping, shapes_only: bool = False
                       ) -> dict:
    """Inverse of :func:`flax_to_state_dict`: a nested dict of float32
    numpy arrays in the flax layout. ``shapes_only`` gives read-only
    zero-stride arrays of the same shapes instead, copying no data (a
    wire codec's template: only shapes and dtypes are read)."""
    tree: dict = {}
    for name, tensor in state_dict.items():
        path, axes = flax_layout(name, tensor.dim())
        if shapes_only:
            arr = np.broadcast_to(np.float32(0), tuple(tensor.shape))
        else:
            arr = tensor.detach().to("cpu", torch.float32).numpy()
        arr = arr.transpose(axes)
        node = tree
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = arr if shapes_only else np.array(arr, order="C")
    return tree


def load_flax_params(model: torch.nn.Module, params: Mapping):
    """Copy flax params (numpy leaves) into ``model``, strictly: every
    parameter must be covered and no name may be left over."""
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model


def _prefixed(prefix: str, state_dict: Mapping) -> dict:
    return {f"{prefix}.{n}": t for n, t in state_dict.items()}


def pipelined_lm_to_state_dict(params: Mapping) -> dict:
    """The JAX package's ``PipelinedLM`` params (numpy leaves; ``blocks``
    stacked ``[P, L/P, ...]``) -> the port's ``PipelinedLM`` state
    dict."""
    out = _prefixed("embed", flax_to_state_dict(params["embed"]))
    out.update(_prefixed("head", flax_to_state_dict(params["head"])))
    blocks = list(_flatten(params["blocks"]))
    num_stages, per_stage = np.shape(blocks[0][1])[:2]
    for s in range(num_stages):
        for j in range(per_stage):
            layer: dict = {}
            for path, leaf in blocks:
                node = layer
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = np.asarray(leaf)[s, j]
            out.update(_prefixed(f"stages.{s}.{j}",
                                 flax_to_state_dict(layer)))
    return out


def state_dict_to_pipelined_lm(state_dict: Mapping) -> dict:
    """Inverse of :func:`pipelined_lm_to_state_dict`."""
    groups: dict = {}
    for name, tensor in state_dict.items():
        part, rest = name.split(".", 1)
        if part == "stages":
            s, j, rest = rest.split(".", 2)
            groups.setdefault((int(s), int(j)), {})[rest] = tensor
        else:
            groups.setdefault(part, {})[rest] = tensor
    layers = sorted(k for k in groups if isinstance(k, tuple))
    num_stages = layers[-1][0] + 1
    per_stage = layers[-1][1] + 1
    trees = [state_dict_to_flax(groups[k]) for k in layers]
    flat = [dict(_flatten(t)) for t in trees]
    blocks: dict = {}
    for path in flat[0]:
        stacked = np.stack([f[path] for f in flat]).reshape(
            (num_stages, per_stage) + flat[0][path].shape)
        node = blocks
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = stacked
    return {"embed": state_dict_to_flax(groups["embed"]), "blocks": blocks,
            "head": state_dict_to_flax(groups["head"])}


def pipeline_stages_to_state_dicts(params) -> tuple:
    """A JAX ``GenericPipeline``'s tuple of per-stage flax trees -> a
    tuple of port state dicts (each stage through this module's rules)."""
    return tuple(flax_to_state_dict(p) for p in params)


def state_dicts_to_pipeline_stages(state_dicts) -> tuple:
    """Inverse of :func:`pipeline_stages_to_state_dicts`."""
    return tuple(state_dict_to_flax(sd) for sd in state_dicts)
