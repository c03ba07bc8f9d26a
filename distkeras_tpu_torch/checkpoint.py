"""Checkpoint and resume (port of ``distkeras_tpu/checkpoint.py``).

The JAX package saves through Orbax, which needs JAX. The port writes
its own layout of DKTP2 containers (:mod:`~distkeras_tpu_torch.utils.serialization`,
the JAX package's params format), one a saved item::

    <directory>/<step>/<item>.dktp

A step is written into ``<step>.tmp/`` and renamed to ``<step>/`` once
every item is on disk, so a crash mid-save leaves no half step behind;
after a save the oldest steps beyond ``max_to_keep`` are deleted. With
``items=None`` a step holds one item named ``default``. A step's
shapes and dtypes are read from its manifests alone
(:meth:`Checkpointer.metadata`), the elastic-resume topology probe.

Orbax's old single-item layout (``restore_legacy`` in the JAX package)
is not readable here: the port never wrote it (ROADMAP.md Queue C,
divergences by design).
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch.utils import serialization as ser

_SUFFIX = ".dktp"
_STEP = re.compile(r"^\d+$")


class LeafMeta(NamedTuple):
    """A saved leaf's shape and dtype name (no data)."""
    shape: tuple
    dtype: str


class Checkpointer:
    """Save, restore and resume with retention.

    Usage::

        ckpt = Checkpointer(dir, max_to_keep=3)
        ckpt.save(step, tree)             # tree: nested dicts/lists of tensors
        tree = ckpt.restore(like=tree)    # latest, or step=N

    ``items=`` makes a step hold several items: ``save`` takes a dict
    keyed by item name and ``restore(items=...)`` reads a subset without
    touching the others' data (a topology-change resume reads the small
    ``state`` item, never the stale ``carries``). Saves are synchronous
    (``wait`` has nothing to wait for); a lock serializes them.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 items: Optional[Sequence[str]] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        self.items = tuple(items) if items is not None else None
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Write ``state`` as step ``step`` (replacing a step of that
        number). Multi-item mode: ``state`` is a dict keyed by declared
        item names."""
        if self.items is None:
            parts = {"default": state}
        else:
            unknown = sorted(set(state) - set(self.items))
            if unknown:
                raise ValueError(
                    f"save() got items {unknown} not declared at "
                    f"construction (items={self.items})")
            parts = dict(state)
        step = int(step)
        with self._lock:
            final = os.path.join(self.directory, str(step))
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for name, tree in parts.items():
                with open(os.path.join(tmp, name + _SUFFIX), "wb") as f:
                    ser.write_params(f, tree)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            if self.max_to_keep > 0:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)),
                                  ignore_errors=True)

    def _resolve_step(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"No checkpoint found under {self.directory}")
        step = int(step)
        if not os.path.isdir(os.path.join(self.directory, str(step))):
            raise FileNotFoundError(
                f"No checkpoint step {step} under {self.directory} "
                f"(steps: {self.all_steps()})")
        return step

    def _path(self, step: int, item: str) -> str:
        path = os.path.join(self.directory, str(step), item + _SUFFIX)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"checkpoint step {step} in {self.directory!r} has no item "
                f"{item!r} (items: {self.step_items(step)})")
        return path

    def _read(self, step: int, item: str, like=None):
        with open(self._path(step, item), "rb") as f:
            return ser.deserialize_params(f.read(), like=like)

    def restore(self, like: Any = None, step: Optional[int] = None,
                host: bool = False,
                items: Optional[Sequence[str]] = None) -> Any:
        """Restore the given (or latest) step. With ``like``, into its
        structure (tensor leaves of ``like`` give tensors on their device;
        ``host=True`` leaves every leaf on the host); without it, nested
        dicts. Multi-item mode: ``like`` is a dict keyed by item name,
        ``items=`` picks what is read (default: every item in ``like``,
        or every declared item); returns a dict of the restored items."""
        step = self._resolve_step(step)
        if host:
            like = None
        if self.items is None:
            return self._read(step, "default", like)
        if items is not None:
            names = tuple(items)
        elif like is not None:
            names = tuple(k for k in self.items if k in like)
        else:
            names = self.items
        return {name: self._read(step, name,
                                 None if like is None else like.get(name))
                for name in names}

    def step_items(self, step: Optional[int] = None) -> list:
        """The item names a saved step holds, read from its directory."""
        step = self._resolve_step(step)
        d = os.path.join(self.directory, str(step))
        return sorted(n[:-len(_SUFFIX)] for n in os.listdir(d)
                      if n.endswith(_SUFFIX))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if _STEP.match(n)
                      and os.path.isdir(os.path.join(self.directory, n)))

    def metadata(self, step: Optional[int] = None,
                 item: Optional[str] = None):
        """Shapes and dtypes of a saved step (nested dicts of
        :class:`LeafMeta`) from its manifests alone, no array data read.
        Multi-item mode: ``item=`` picks one item; without it, a dict
        keyed by item name."""
        step = self._resolve_step(step)

        def one(name):
            path = self._path(step, name)
            with open(path, "rb") as f:
                head = f.read(14)
                need = 14 + int.from_bytes(head[6:14], "little")
                manifest, _ = ser.read_manifest(head + f.read(need - 14))
            return ser._nest({leaf["key"]: LeafMeta(tuple(leaf["shape"]),
                                                    leaf["dtype"])
                              for leaf in manifest})

        if self.items is None:
            return one("default")
        if item is not None:
            return one(item)
        return {name: one(name) for name in self.step_items(step)}

    def clear(self) -> None:
        """Delete every saved step."""
        with self._lock:
            for step in self.all_steps():
                shutil.rmtree(os.path.join(self.directory, str(step)),
                              ignore_errors=True)

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        """Nothing is held open between calls."""


# -- optimizer state as a tree -------------------------------------------------

def optimizer_tree(opt) -> dict:
    """A ``torch.optim`` optimizer's per-parameter state (or an
    ``OverflowGuardState``'s, with its ``[scale, good_steps]``) as a tree
    of arrays: ``{"state": {index: {key: tensor}}}``. Python numbers in
    the state (a step count) are kept as 0-d arrays under ``key@int``,
    ``key@float`` or ``key@bool`` so that they come back as they were;
    None entries are left out. The hyperparameters are not saved: the
    optimizer a resume builds has them."""
    from distkeras_tpu_torch.precision import OverflowGuardState

    if opt is None:
        return {}
    if isinstance(opt, OverflowGuardState):
        return {"inner": optimizer_tree(opt.inner),
                "guard": np.array([opt.scale, opt.good_steps], np.float64)}
    out = {}
    for index, state in opt.state_dict()["state"].items():
        entry = {}
        for key, value in state.items():
            if value is None:
                continue
            if isinstance(value, torch.Tensor):
                entry[key] = value
            elif isinstance(value, bool):
                entry[key + "@bool"] = np.asarray(value)
            elif isinstance(value, int):
                entry[key + "@int"] = np.asarray(value, np.int64)
            elif isinstance(value, float):
                entry[key + "@float"] = np.asarray(value, np.float64)
            else:
                raise TypeError(f"optimizer state {key!r} holds a "
                                f"{type(value).__name__}, not a tensor or "
                                f"a number")
        out[str(index)] = entry
    return {"state": out}


def load_optimizer_tree(opt, tree: dict) -> None:
    """Put :func:`optimizer_tree`'s output back into ``opt`` (built over
    the same parameters with the same hyperparameters) through
    ``load_state_dict``, which places each tensor as torch's own resume
    does."""
    from distkeras_tpu_torch.precision import OverflowGuardState

    if opt is None:
        return
    if isinstance(opt, OverflowGuardState):
        load_optimizer_tree(opt.inner, tree.get("inner", {}))
        guard = np.asarray(tree["guard"])
        opt.scale, opt.good_steps = float(guard[0]), int(guard[1])
        return
    state = {}
    for index, entry in tree.get("state", {}).items():
        restored = {}
        for key, value in entry.items():
            name, _, kind = key.partition("@")
            if kind == "int":
                restored[name] = int(value)
            elif kind == "float":
                restored[name] = float(value)
            elif kind == "bool":
                restored[name] = bool(value)
            else:
                restored[name] = value if isinstance(value, torch.Tensor) \
                    else torch.from_numpy(np.array(value))
        state[int(index)] = restored
    sd = opt.state_dict()
    sd["state"] = state
    opt.load_state_dict(sd)


def save_params(path: str, params) -> None:
    """One-shot params save (a Keras ``model.save()`` analogue): one DKTP2
    container, leaves streamed to the file."""
    with open(path, "wb") as f:
        ser.write_params(f, params)


def load_params(path: str, like=None):
    with open(path, "rb") as f:
        return ser.deserialize_params(f.read(), like=like)
