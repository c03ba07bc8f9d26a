"""Parameter servers (port of ``distkeras_tpu/parameter_servers.py``):
the center variable on a device, with the reference's commit/pull
vocabulary.

The trainer zoo's sync path does not go through this class: the
substrate folds each round's commits itself
(:mod:`distkeras_tpu_torch.parallel.substrate`). It exists for API
parity, for the golden tests that apply the reference's commits one at
a time, and as the host-side fold the true-async plane
(:mod:`distkeras_tpu_torch.parallel.host_async`, behind
:mod:`~distkeras_tpu_torch.parallel.remote_ps`'s service) runs on. The
center is a name -> tensor dict on the server's device (the device of
the tensors it was given); a lock orders
the folds, as the reference's ``threading.Lock`` did. Any tree of
tensors works (a nested flax-layout dict, or one fleet shard's list of
leaves): the fold maps over its leaves in the JAX package's order.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Union

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.utils.trees import tree_leaves, tree_map


def _fold(center, delta, weight: float):
    """``c + (w * d)`` per leaf with ``w`` rounded to float32 and each
    scaled delta cast to its center leaf's dtype (a codec may deliver
    deltas in a lower precision; the center keeps its own)."""
    w = torch.tensor(weight, dtype=torch.float32)
    return tree_map(lambda c, d: c + (w * d).to(c.dtype), center, delta)


class ParameterServer:
    """Base: holds the center variable and an update counter."""

    def __init__(self, params):
        self.center_variable = _own(params)
        self.num_updates = 0
        # deployment counter, NOT the training clock: bumped by a
        # WeightPublisher when a snapshot of this center is published
        # for serving; survives initialize()
        self.model_version = 0
        self._lock = threading.Lock()

    def initialize(self, params) -> None:
        with self._lock:
            self.center_variable = _own(params)
            self.num_updates = 0

    def pull(self):
        """``(center, clock)``: DynSGD needs the clock to compute the
        staleness of its next commit."""
        with self._lock:
            out = self.center_variable, self.num_updates
        telemetry.counter("ps.pull.count").inc()
        return out

    def pull_versioned(self):
        """``(center, clock, model_version)`` in one coherent read."""
        with self._lock:
            out = (self.center_variable, self.num_updates,
                   self.model_version)
        telemetry.counter("ps.pull.count").inc()
        return out

    def set_model_version(self, version: int) -> None:
        """Stamp the published version onto the center; a version that is
        not above the current one raises ValueError."""
        version = int(version)
        with self._lock:
            if version <= self.model_version:
                raise ValueError(
                    f"model_version must be monotone: {version} <= "
                    f"current {self.model_version}")
            self.model_version = version

    def _note_commit(self, staleness: int, dur_s: float) -> None:
        telemetry.counter("ps.commit.count").inc()
        telemetry.histogram("ps.commit.staleness").record(staleness)
        telemetry.histogram("ps.commit.handle_s").record(dur_s)
        telemetry.histogram("profile.phase.fold_s").record(dur_s)

    def fold_weight(self, staleness: int) -> float:
        """The server rule's scale for a commit folded at ``staleness``
        (clock at fold minus clock at the committer's pull): 1.0 here;
        DynSGD overrides."""
        return 1.0

    def commit(self, delta: dict, last_update: int = 0) -> int:
        """Fold a delta into the center; returns the clock at fold time
        (before this commit increments it)."""
        return self.commit_ex(delta, last_update=last_update)[0]

    def commit_ex(self, delta: dict, last_update: int = 0,
                  weight: Union[None, float, Callable] = None) -> tuple:
        """:meth:`commit` with the fold weight surfaced and overridable:
        ``weight=None`` applies :meth:`fold_weight`, a float that exact
        scale, a callable ``weight(staleness)`` evaluated under the lock.
        Returns ``(at_fold, applied_weight)``."""
        delta = self._to_center_device(delta)
        t0 = time.perf_counter()
        with telemetry.span("trace.fold"):
            with self._lock:
                at_fold = self.num_updates
                staleness = at_fold - int(last_update)
                if weight is None:
                    w = self.fold_weight(staleness)
                elif callable(weight):
                    w = float(weight(staleness))
                else:
                    w = float(weight)
                self.center_variable = _fold(self.center_variable, delta, w)
                self.num_updates += 1
        self._note_commit(staleness, time.perf_counter() - t0)
        return at_fold, w

    def replay(self, delta: dict, at_fold: int, weight: float,
               last_update: int = 0) -> int:
        """Apply one write-behind-log record: the same delta at the same
        clock with the same float32 weight through the same fold. The
        clock is pinned to ``at_fold`` first; returns the gap that pin
        closed (0 when no record was lost)."""
        delta = self._to_center_device(delta)
        t0 = time.perf_counter()
        with telemetry.span("trace.fold", replay=True):
            with self._lock:
                gap = int(at_fold) - self.num_updates
                self.num_updates = int(at_fold)
                self.center_variable = _fold(self.center_variable, delta,
                                             float(weight))
                self.num_updates += 1
        self._note_commit(int(at_fold) - int(last_update),
                          time.perf_counter() - t0)
        return gap

    def _to_center_device(self, tree):
        """Bring a worker's delta to the center's device (the hop the
        reference's executor-to-master TCP send was); a decoded wire
        tree (numpy leaves) goes through pinned memory."""
        from distkeras_tpu_torch.utils.transfer import to_device

        leaves = tree_leaves(self.center_variable)
        if not leaves:
            return tree
        return to_device(tree, leaves[0].device)

    # reference lifecycle names (no socket to start or stop)
    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


def _own(params):
    """The server's own reference to a tree: a dict is copied shallowly
    (a caller's later key changes do not reach the center); numpy leaves
    become tensors."""
    return tree_map(lambda x: x if isinstance(x, torch.Tensor)
                    else torch.from_numpy(np.array(x)), params)


class DeltaParameterServer(ParameterServer):
    """center += delta (the DOWNPOUR/ADAG/(A)EASGD server rule; ADAG's
    window normalization is in the worker's commit)."""


# the reference gives ADAG its own server class; the fold is the same
ADAGParameterServer = DeltaParameterServer


def dynsgd_fold_weight(staleness: int) -> float:
    """The DynSGD server rule, 1/(staleness + 1), as a host float; in
    float32 it equals ``strategies.DynSGD.staleness_weight``."""
    if staleness < 0:
        raise ValueError(
            f"staleness must be >= 0, got {staleness} (committer's "
            f"last_update is ahead of the server clock)")
    return 1.0 / (float(staleness) + 1.0)


class DynSGDParameterServer(ParameterServer):
    """center += delta / (staleness + 1), staleness = server clock at
    commit minus server clock at the committer's last pull."""

    def fold_weight(self, staleness: int) -> float:
        return dynsgd_fold_weight(staleness)
