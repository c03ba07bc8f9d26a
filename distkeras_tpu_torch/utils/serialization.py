"""Model and parameter (de)serialization (port of
``distkeras_tpu/utils/serialization.py``), in the JAX package's DKTP2
container, byte for byte:

    b"DKTP2\\0" | manifest length (8 bytes, little-endian) |
    JSON manifest {"leaves": [{"key", "shape", "dtype"}, ...]} |
    each leaf's raw little-endian bytes, in manifest order

Keys are the tree's paths joined by ``/`` (dict keys sorted, as JAX
flattens them; list and tuple positions as their index), so the same
numpy tree gives the same bytes in both packages, and a container either
one writes loads in the other (flax-layout trees cross through
:mod:`~distkeras_tpu_torch.utils.bridge`). Version-1 ``.npz`` blobs stay
readable.

A tree here is nested dicts, lists and tuples whose leaves are torch
tensors (moved to the host), numpy arrays or Python numbers; a flat
``state_dict`` is a one-level tree. ``bfloat16`` and the float8 leaves
are written and read through torch dtypes and raw bytes (the JAX module
reads them through ``ml_dtypes``, which the port does not need), so a
bf16 leaf round-trips bit for bit; numpy has no such dtypes, so these
leaves come back as CPU torch tensors and every other leaf as a numpy
array.
"""

from __future__ import annotations

import importlib
import inspect
import io
import json
from typing import Any, Tuple

import numpy as np
import torch

_SEP = "/"
_MAGIC = b"DKTP2\x00"

#: leaf dtypes numpy lacks: manifest name <-> torch dtype
_TORCH_ONLY = {"bfloat16": torch.bfloat16}
for _name in ("float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
              "float8_e5m2fnuz"):
    if hasattr(torch, _name):
        _TORCH_ONLY[_name] = getattr(torch, _name)
_TORCH_NAMES = {dt: name for name, dt in _TORCH_ONLY.items()}


def _flatten(tree, prefix=()) -> list:
    """``[(path, leaf)]`` in JAX's order (dict keys sorted); None
    leaves are dropped, as ``jax.tree_util`` drops them."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], prefix + (str(key),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, item in enumerate(tree):
            out += _flatten(item, prefix + (str(i),))
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def _leaf(value) -> Tuple[str, tuple, memoryview]:
    """``(dtype name, shape, raw bytes)`` of one leaf."""
    from distkeras_tpu_torch.comms.chunking import leaf_buffer

    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu").contiguous()
        if t.dtype in _TORCH_NAMES:
            raw = t.reshape(-1).view(torch.uint8).numpy()
            return _TORCH_NAMES[t.dtype], tuple(t.shape), memoryview(raw)
        value = t.numpy()
    arr = np.asarray(value)
    return arr.dtype.name, arr.shape, leaf_buffer(arr)


def param_buffers(params) -> Tuple[bytes, list]:
    """The v2 container as (header bytes, zero-copy leaf buffers): the
    streaming form (:func:`write_params` writes the buffers without
    joining them)."""
    manifest, buffers = [], []
    for path, value in _flatten(params):
        dtype, shape, buf = _leaf(value)
        manifest.append({"key": _SEP.join(path), "shape": list(shape),
                         "dtype": dtype})
        buffers.append(buf)
    mb = json.dumps({"leaves": manifest}).encode()
    return _MAGIC + len(mb).to_bytes(8, "little") + mb, buffers


def write_params(fileobj, params) -> int:
    """Stream a tree to a file object (v2 container); returns the byte
    count."""
    from distkeras_tpu_torch.comms.chunking import write_buffers

    header, buffers = param_buffers(params)
    fileobj.write(header)
    return len(header) + write_buffers(fileobj, buffers)


def serialize_params(params) -> bytes:
    """Tree -> v2 container bytes with path-encoded names."""
    header, buffers = param_buffers(params)
    return b"".join([header, *buffers])


def read_manifest(data: bytes) -> Tuple[list, int]:
    """``(manifest leaves, offset of the first leaf's bytes)`` of a v2
    container (or its leading bytes): no leaf data is read."""
    if data[:len(_MAGIC)] != _MAGIC:
        raise ValueError("not a DKTP2 params container")
    body = len(_MAGIC) + 8
    if len(data) < body:
        raise ValueError("params container truncated in its header")
    n = int.from_bytes(data[len(_MAGIC):body], "little")
    if len(data) < body + n:
        raise ValueError("params container truncated in its manifest")
    return json.loads(data[body:body + n].decode())["leaves"], body + n


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _load_v2(data: bytes) -> dict:
    manifest, off = read_manifest(data)
    flat = {}
    for leaf in manifest:
        shape = tuple(leaf["shape"])
        count = _numel(shape)
        name = leaf["dtype"]
        if name in _TORCH_ONLY:
            dt = _TORCH_ONLY[name]
            size = count * torch.empty((), dtype=dt).element_size()
            if off + size > len(data):
                raise ValueError(f"params container is {len(data)} bytes, "
                                 f"truncated in leaf {leaf['key']!r}")
            raw = bytearray(data[off:off + size])
            flat[leaf["key"]] = torch.frombuffer(
                raw, dtype=torch.uint8).view(dt).reshape(shape) \
                if size else torch.empty(shape, dtype=dt)
        else:
            dt = np.dtype(name)
            size = count * dt.itemsize
            if off + size > len(data):
                raise ValueError(f"params container is {len(data)} bytes, "
                                 f"truncated in leaf {leaf['key']!r}")
            flat[leaf["key"]] = np.frombuffer(
                data, dtype=dt, count=count, offset=off).reshape(shape)
        off += size
    if off != len(data):
        raise ValueError(f"params container is {len(data)} bytes but the "
                         f"manifest accounts for {off}")
    return flat


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, val in flat.items():
        node = out
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def _like_leaf(value, like):
    """``value`` placed like ``like``: a tensor on like's device (the
    stored dtype kept), else a numpy array."""
    if isinstance(like, torch.Tensor):
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.array(value))
        return t.to(like.device)
    return value


def _rebuild(like, flat: dict, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], flat, prefix + (str(k),))
                for k in like}
    if isinstance(like, (list, tuple)):
        items = [_rebuild(x, flat, prefix + (str(i),))
                 for i, x in enumerate(like)]
        return type(like)(items)
    if like is None:
        return None
    return _like_leaf(flat[_SEP.join(prefix)], like)


def deserialize_params(data: bytes, like=None):
    """Container bytes -> tree (v2, with the v1 ``.npz`` fallback). A
    truncated or overlong container raises ValueError. With ``like``, the
    result has like's structure (the key sets must match) and a tensor
    leaf of ``like`` gives a tensor on its device; without it, nested
    dicts from the path keys."""
    if data[:len(_MAGIC)] == _MAGIC:
        flat = _load_v2(data)
    else:  # v1 blobs are zip archives
        with np.load(io.BytesIO(data)) as npz:
            flat = {k: npz[k] for k in npz.files}
    if like is None:
        return _nest(flat)
    keys = [_SEP.join(path) for path, _ in _flatten(like)]
    if set(keys) != set(flat):
        missing = set(keys) ^ set(flat)
        raise ValueError(f"Param keys mismatch: {sorted(missing)[:5]}...")
    return _rebuild(like, flat)


# -- architecture + weights ----------------------------------------------------

_SKIP = object()  # a value with no JSON form


def _jsonable(value):
    if isinstance(value, (bool, int, float, str, type(None))):
        return value
    if isinstance(value, (tuple, list)):
        items = [_jsonable(v) for v in value]
        return None if any(i is _SKIP for i in items) else items
    if isinstance(value, torch.dtype):
        return {"__dtype__": str(value).replace("torch.", "")}
    if inspect.isclass(value):
        return {"__class__": f"{value.__module__}:{value.__qualname__}"}
    return _SKIP


def _unjsonable(value):
    if isinstance(value, list):
        return tuple(_unjsonable(v) for v in value)
    if isinstance(value, dict) and "__dtype__" in value:
        return getattr(torch, value["__dtype__"])
    if isinstance(value, dict) and "__class__" in value:
        module, qualname = value["__class__"].split(":")
        obj = importlib.import_module(module)
        for part in qualname.split("."):
            obj = getattr(obj, part)
        return obj
    return value


def constructor_kwargs(model) -> dict:
    """The constructor kwargs of ``model``, read back from the module's
    attributes of the same names (every model family of the port keeps
    them); a kwarg the module does not keep raises ValueError rather
    than being rebuilt at its default."""
    out, missing = {}, []
    for name, p in inspect.signature(type(model).__init__).parameters.items():
        if name == "self" or p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if name in vars(model):
            out[name] = vars(model)[name]
        else:
            missing.append(name)
    if missing:
        raise ValueError(f"{type(model).__name__} does not keep its "
                         f"constructor kwargs {missing} as attributes, so "
                         f"it cannot be rebuilt")
    return out


def _model_config(model) -> dict:
    """:func:`constructor_kwargs` as JSON-able values (dtypes and classes
    tagged); a value with no JSON form raises ValueError."""
    cfg, missing = {}, []
    try:
        kwargs = constructor_kwargs(model)
    except ValueError as e:
        raise ValueError(f"serialize_model: {e}") from None
    for name, value in kwargs.items():
        val = _jsonable(value)
        if val is _SKIP:
            missing.append(name)
        else:
            cfg[name] = val
    if missing:
        raise ValueError(f"serialize_model: {type(model).__name__} does not "
                         f"keep its constructor kwargs {missing} as "
                         f"attributes, so it cannot be rebuilt")
    return cfg


def serialize_model(model, params=None) -> bytes:
    """The module's class and constructor kwargs (JSON) with its
    parameters (``params``, a name -> tensor dict; the module's
    ``state_dict()`` when None) in one blob, laid out as the JAX
    package's (8-byte big-endian architecture length, architecture,
    container)."""
    arch = {"module": type(model).__module__, "cls": type(model).__name__,
            "config": _model_config(model)}
    arch_bytes = json.dumps(arch).encode()
    if params is None:
        params = model.state_dict()
    return len(arch_bytes).to_bytes(8, "big") + arch_bytes \
        + serialize_params(params)


def deserialize_model(blob: bytes) -> Tuple[Any, Any]:
    """Inverse of :func:`serialize_model`: ``(model, params)``, the
    model rebuilt from its class path and kwargs with the parameters
    loaded into it (strictly)."""
    n = int.from_bytes(blob[:8], "big")
    arch = json.loads(blob[8:8 + n].decode())
    params = deserialize_params(blob[8 + n:])
    cls = getattr(importlib.import_module(arch["module"]), arch["cls"])
    model = cls(**{k: _unjsonable(v) for k, v in arch["config"].items()})
    state = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v)) for k, v in params.items()}
    model.load_state_dict(state, strict=True)
    return model, params


def uniform_weights(params: dict, seed: int, low: float = -0.5,
                    high: float = 0.5) -> dict:
    """Re-initialize every leaf U(low, high) from ``seed`` (the
    reference's ``utils.uniform_weights``): floating leaves keep their
    dtype and device, others become float32."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, leaf in params.items():
        leaf = torch.as_tensor(leaf)
        dtype = leaf.dtype if leaf.is_floating_point() else torch.float32
        draw = torch.rand(leaf.shape, generator=gen, dtype=torch.float32)
        out[name] = (low + (high - low) * draw).to(leaf.device, dtype)
    return out
