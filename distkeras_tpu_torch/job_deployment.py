"""Job deployment (port of ``distkeras_tpu/job_deployment.py``):
``Job``, ``Punchcard``, ``JobHandle`` and ``LocalLauncher``.

A ``Job`` is a declarative spec (a trainer name + kwargs + a data
source) that runs in-process or is handed to a launcher; a
``Punchcard`` is a JSON file holding a queue of such specs, run in
order. Trainer names resolve in :mod:`distkeras_tpu_torch.trainers`, and
a job's trainer runs where the port's trainers run: on ``cuda:0``
unless its kwargs say ``device="cpu"`` (or pass a mesh).

No SSH is implemented (launchers own placement): ``Job.run`` executes
against this process's devices. The reference's submit-and-poll shape is
kept: ``LocalLauncher.submit(bundle_dir)`` launches a saved bundle's
entry script in a fresh interpreter (with this package importable) and
returns a ``JobHandle`` with the poll/wait/results verbs; a remote
transport only swaps the process spawn for its own dispatch.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import uuid
from typing import Any, Callable, Optional

from distkeras_tpu_torch.data.dataset import Dataset

_TRAINER_REGISTRY: Optional[dict] = None


def _trainers() -> dict:
    global _TRAINER_REGISTRY
    if _TRAINER_REGISTRY is None:
        from distkeras_tpu_torch import trainers as t

        _TRAINER_REGISTRY = {
            name: getattr(t, name)
            for name in ("SingleTrainer", "AveragingTrainer",
                         "EnsembleTrainer", "DOWNPOUR", "ADAG", "DynSGD",
                         "AEASGD", "EAMSGD", "PjitTrainer")
        }
    return _TRAINER_REGISTRY


def _resolve(dotted: str) -> Callable:
    module, _, attr = dotted.partition(":")
    import importlib

    return getattr(importlib.import_module(module), attr)


class Job:
    """One training job: trainer name + kwargs + a data provider.

    ``model`` may be a live module or a dotted ``"module:callable"`` path
    (invoked with no args at run time); ``data`` may be a Dataset, a
    zero-arg callable, or a dotted path. Dotted-path jobs are fully
    declarative — they serialize to punchcard JSON and into launchable
    bundles (:meth:`Punchcard.save_bundle`).
    """

    def __init__(self, job_name: str, trainer: str, model,
                 data, num_epoch: int = 1, shuffle: bool = False,
                 **trainer_kwargs):
        self.job_name = job_name
        self.trainer_name = trainer
        self.model = model
        self.data = data
        self.shuffle = shuffle
        self.trainer_kwargs = dict(trainer_kwargs, num_epoch=num_epoch)
        self.result: Any = None
        self.history: Optional[list] = None
        self.training_time: Optional[float] = None
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None

    def run(self):
        cls = _trainers()[self.trainer_name]
        model = (_resolve(self.model)() if isinstance(self.model, str)
                 else self.model)
        trainer = cls(model, **self.trainer_kwargs)
        data = (_resolve(self.data) if isinstance(self.data, str)
                else self.data)
        dataset = data() if callable(data) else data
        if not isinstance(dataset, Dataset):
            raise TypeError(f"Job data must resolve to a Dataset, "
                            f"got {type(dataset)}")
        self.started_at = time.time()
        self.result = trainer.train(dataset, shuffle=self.shuffle)
        self.finished_at = time.time()
        self.history = trainer.get_history()
        self.training_time = trainer.get_training_time()
        return self.result

    def to_spec(self) -> dict:
        """Declarative JSON spec of this job (punchcard/bundle format).

        Requires dotted-path model/data — a live module or in-memory
        Dataset cannot be handed to an external launcher honestly.
        """
        if not isinstance(self.model, str) or not isinstance(self.data, str):
            raise TypeError(
                f"Job {self.job_name!r} holds a live "
                f"{'model' if not isinstance(self.model, str) else 'dataset'}"
                "; bundles need dotted 'module:callable' paths for model "
                "and data so any launcher can reconstruct them")
        spec = {"job_name": self.job_name, "trainer": self.trainer_name,
                "model": self.model, "data": self.data,
                "shuffle": self.shuffle}
        spec.update(self.trainer_kwargs)
        return spec

    def describe(self) -> dict:
        return {"job_name": self.job_name, "trainer": self.trainer_name,
                "trainer_kwargs": {k: v for k, v in self.trainer_kwargs.items()
                                   if isinstance(v, (int, float, str, bool))},
                "training_time": self.training_time}


class Punchcard:
    """An ordered queue of jobs, optionally loaded from a JSON spec file.

    JSON shape: ``[{"job_name": ..., "trainer": "ADAG", "model":
    "distkeras_tpu_torch.models.mlp:mnist_mlp", "data":
    "distkeras_tpu_torch.data.dataset:synthetic_mnist", ...kwargs}]``:
    model/data entries are dotted ``module:callable`` paths invoked with
    no args.
    """

    def __init__(self, jobs: Optional[list] = None,
                 path: Optional[str] = None):
        self.jobs: list[Job] = list(jobs or [])
        if path is not None:
            self.jobs.extend(self._load(path))
        self.results: list[dict] = []

    @staticmethod
    def _resolve(dotted: str) -> Callable:
        return _resolve(dotted)

    @classmethod
    def _load(cls, path: str) -> list[Job]:
        with open(path) as f:
            specs = json.load(f)
        # dotted paths stay strings (resolved lazily at run()) so a loaded
        # punchcard re-serializes losslessly — but validate them NOW: a
        # typo'd path in job 5 must fail at load, not after job 1-4 trained
        for spec in specs:
            for key in ("model", "data"):
                if isinstance(spec.get(key), str):
                    _resolve(spec[key])
        return [Job(**spec) for spec in specs]

    def submit(self, job: Job):
        self.jobs.append(job)

    def run(self) -> list[dict]:
        """Run every job in order; returns their describe() dicts."""
        for job in self.jobs:
            job.run()
            self.results.append(job.describe())
        return self.results

    def save_bundle(self, directory: str) -> str:
        """Serialize a launchable job bundle: everything a launcher needs,
        in one directory (the reference submitted jobs to a remote head
        node).

        Contents: ``punchcard.json`` (declarative job specs),
        ``run_punchcard.py`` (self-contained entry script), and
        ``ENVIRONMENT.md`` (pinned interpreter + dependency versions).
        Returns the directory path.
        """
        import platform
        from importlib import metadata

        os.makedirs(directory, exist_ok=True)
        specs = [job.to_spec() for job in self.jobs]
        with open(os.path.join(directory, "punchcard.json"), "w") as f:
            json.dump(specs, f, indent=2)

        entry = (
            '"""Launchable bundle entry: run the punchcard in this '
            'directory."""\n'
            "import json\n"
            "import os\n"
            "import sys\n\n"
            "from distkeras_tpu_torch.job_deployment import Punchcard\n\n"
            'HERE = os.path.dirname(os.path.abspath(__file__))\n\n'
            "def main():\n"
            "    card = Punchcard(path=os.path.join(HERE, "
            '"punchcard.json"))\n'
            "    results = card.run()\n"
            "    print(json.dumps(results, indent=2))\n"
            "    return 0\n\n"
            'if __name__ == "__main__":\n'
            "    sys.exit(main())\n")
        with open(os.path.join(directory, "run_punchcard.py"), "w") as f:
            f.write(entry)

        deps = []
        for pkg in ("torch", "numpy"):
            try:
                deps.append(f"- {pkg}=={metadata.version(pkg)}")
            except metadata.PackageNotFoundError:
                deps.append(f"- {pkg} (not installed here; any compatible "
                            "version)")
        env = ("# Bundle environment\n\n"
               f"Serialized on python {platform.python_version()} "
               f"({platform.machine()}).\n\n"
               "Launcher contract: `python run_punchcard.py` with the\n"
               "`distkeras_tpu_torch` package importable and the versions\n"
               "below (or compatible) installed. Jobs run on cuda:0 unless\n"
               "their kwargs say device=\"cpu\".\n\n"
               + "\n".join(deps) + "\n")
        with open(os.path.join(directory, "ENVIRONMENT.md"), "w") as f:
            f.write(env)
        return directory


class JobHandle:
    """A submitted bundle: poll / wait / fetch results.

    The reference's Job polled a remote head node over TCP for completion;
    the contract here is the same three verbs against whatever executor the
    launcher bound (``poll() -> "RUNNING"|"SUCCEEDED"|"FAILED"``,
    ``wait()``, ``results()``), with the transport behind them swappable.
    """

    def __init__(self, proc: subprocess.Popen, bundle_dir: str,
                 results_tmp: Optional[str] = None,
                 log_tmp: Optional[str] = None):
        self._proc = proc
        self.bundle_dir = bundle_dir
        # per-submission tmp paths: unique per child, so re-submitting the
        # same bundle while a prior job still runs can't interleave two
        # children's writes into one inode
        self._results_tmp = results_tmp or self.results_path + ".tmp"
        self._log_tmp = log_tmp or self.log_path + ".tmp"
        self._finalized = False

    @property
    def results_path(self) -> str:
        return os.path.join(self.bundle_dir, "results.json")

    @property
    def log_path(self) -> str:
        return os.path.join(self.bundle_dir, "job.log")

    def _finalize(self, status: str) -> None:
        """Promote the child's ``.tmp`` artifacts at terminal status.
        ``results.json`` is replaced only on SUCCESS — a job that launched
        but then failed must not destroy a previous run's results (the
        failed run's partial stdout is discarded). ``job.log`` is promoted
        either way: the failure tail lives there.

        Promotion happens on the submitter's first ``poll()``/``wait()``
        after the job ends (results()/wait() both route through poll) —
        until then ``results.json`` still holds the PREVIOUS run. External
        readers should watch the handle, not the bare file."""
        if self._finalized:
            return
        if os.path.exists(self._log_tmp):
            os.replace(self._log_tmp, self.log_path)
        if status == "SUCCEEDED":
            if os.path.exists(self._results_tmp):
                os.replace(self._results_tmp, self.results_path)
        elif os.path.exists(self._results_tmp):
            os.unlink(self._results_tmp)
        self._finalized = True  # only after promotion fully succeeded

    def poll(self) -> str:
        rc = self._proc.poll()
        if rc is None:
            return "RUNNING"
        status = "SUCCEEDED" if rc == 0 else "FAILED"
        self._finalize(status)
        return status

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until the job finishes (the reference's poll loop, folded
        into one call). Returns the terminal status — or "RUNNING" if
        ``timeout`` elapsed first (the job is still going; wait again or
        poll)."""
        try:
            self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return "RUNNING"
        return self.poll()

    def results(self) -> list:
        """Parsed describe() dicts of every job in the bundle. Raises if the
        job is still running or failed (with the log tail for diagnosis)."""
        status = self.poll()
        if status == "RUNNING":
            raise RuntimeError("job still running; wait() first")
        if status == "FAILED":
            tail = ""
            if os.path.exists(self.log_path):
                with open(self.log_path, "rb") as f:
                    f.seek(max(0, os.path.getsize(self.log_path) - 2000))
                    tail = f.read().decode(errors="replace")
            raise RuntimeError(f"job failed (rc={self._proc.returncode}); "
                               f"log tail:\n{tail}")
        with open(self.results_path) as f:
            return json.load(f)


class LocalLauncher:
    """Submit-and-poll executor for saved bundles: the reference's remote
    job-deployment shape with the transport bound to a local subprocess.
    It executes the bundle's own entry script in a fresh interpreter on
    this host. The submit/poll/results contract is transport-agnostic: a
    remote backend only swaps ``subprocess.Popen`` for its own
    dispatch."""

    def __init__(self, python: Optional[str] = None,
                 env: Optional[dict] = None):
        self.python = python or sys.executable
        self.env = env

    def submit(self, bundle_dir: str) -> JobHandle:
        """Launch ``run_punchcard.py`` detached; results land in
        ``results.json``, interleaved stdout/stderr in ``job.log``."""
        entry = os.path.join(bundle_dir, "run_punchcard.py")
        if not os.path.exists(entry):
            raise FileNotFoundError(
                f"{bundle_dir!r} is not a bundle (no run_punchcard.py); "
                f"create one with Punchcard.save_bundle")
        env = dict(self.env if self.env is not None else os.environ)
        # the bundle contract requires distkeras_tpu_torch importable in
        # the child; fall back to this interpreter's copy AFTER any
        # caller-supplied PYTHONPATH so an env override (pinned or patched
        # checkout) wins over the launcher's own package
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (env.get("PYTHONPATH"), pkg_root) if p)
        # entry prints results JSON on stdout; capture it into the bundle.
        # The child writes to UNIQUELY-NAMED .tmp paths for its whole life
        # (uuid suffix: two submits of one bundle never share an inode);
        # JobHandle promotes them at terminal status (results.json only on
        # success) — neither a bad interpreter path NOR a job that launches
        # and then fails can destroy a previous run's results.
        suffix = ".tmp." + uuid.uuid4().hex[:8]
        results_tmp = os.path.join(bundle_dir, "results.json" + suffix)
        log_tmp = os.path.join(bundle_dir, "job.log" + suffix)
        with open(results_tmp, "w") as out, open(log_tmp, "w") as log:
            try:
                proc = subprocess.Popen(
                    [self.python, entry], stdout=out, stderr=log,
                    env=env, cwd=bundle_dir)
            except OSError:
                os.unlink(out.name)
                os.unlink(log.name)
                raise
        return JobHandle(proc, bundle_dir, results_tmp, log_tmp)
