"""The port's job deployment and one-process distributed helpers against
the JAX package's (``tests/test_jobs_distributed.py``'s contracts):
``Job``, ``Punchcard`` JSON and bundle round trips, ``LocalLauncher``
submit/poll/results in a fresh interpreter with a timeout, a failing
bundle's log, and ``parallel.distributed`` on one process. Port jobs
run with ``device="cpu"``: a job's trainer otherwise runs on ``cuda:0``.
"""

import json
import os
import sys

import pytest
import torch

from distkeras_tpu import job_deployment as jjobs
from distkeras_tpu_torch.data.dataset import synthetic_mnist
from distkeras_tpu_torch.job_deployment import (Job, JobHandle,
                                                LocalLauncher, Punchcard)
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.parallel import distributed
from distkeras_tpu_torch.parallel import mesh as mesh_lib

MODEL = "distkeras_tpu_torch.models.mlp:mnist_mlp"
DATA = "distkeras_tpu_torch.data.dataset:synthetic_mnist"


def _tiny_data():
    return synthetic_mnist(n=256)


def test_job_runs_single_trainer():
    job = Job("smoke", "SingleTrainer", MLP(features=(16,)), _tiny_data,
              batch_size=64, num_epoch=1, device="cpu")
    params = job.run()
    assert params and job.training_time > 0
    assert len(job.history) == 4  # 256/64 steps
    d = job.describe()
    assert d["job_name"] == "smoke" and d["trainer"] == "SingleTrainer"
    assert d["trainer_kwargs"]["device"] == "cpu"


@pytest.mark.parametrize("trainer", ["ADAG", "PjitTrainer"])
def test_job_distributed_trainer(trainer):
    kw = dict(communication_window=2, parallelism_factor=4) \
        if trainer == "ADAG" else dict(num_workers=4)
    job = Job(trainer.lower(), trainer, MLP(features=(16,)), _tiny_data,
              batch_size=16, device="cpu", **kw)
    params = job.run()
    assert all(torch.isfinite(v).all() for v in params.values())


def test_job_names_resolve_in_the_port_and_match_jax():
    from distkeras_tpu_torch import job_deployment, trainers

    names = job_deployment._trainers()
    assert sorted(names) == sorted(jjobs._trainers())
    for name, cls in names.items():
        assert cls is getattr(trainers, name)


def test_punchcard_json_roundtrip(tmp_path):
    spec = [{"job_name": "mnist-mlp", "trainer": "SingleTrainer",
             "model": MODEL, "data": DATA, "batch_size": 512,
             "num_epoch": 1, "device": "cpu"}]
    path = tmp_path / "punchcard.json"
    path.write_text(json.dumps(spec))
    card = Punchcard(path=str(path))
    assert [j.to_spec() for j in card.jobs] == [
        dict(s, shuffle=False) for s in spec]
    results = card.run()
    assert len(results) == 1 and results[0]["training_time"] > 0
    # the same spec is JAX's (only the dotted paths name the port)
    jcard = jjobs.Punchcard(jobs=[jjobs.Job(**dict(spec[0]))])
    assert jcard.jobs[0].to_spec() == card.jobs[0].to_spec()
    with pytest.raises((ImportError, AttributeError)):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps([dict(spec[0], model="nope.mod:fn")]))
        Punchcard(path=str(bad))


def test_punchcard_save_bundle_roundtrip(tmp_path):
    card = Punchcard(jobs=[Job("bundled-mnist", "SingleTrainer",
                               model=MODEL, data=DATA, batch_size=512,
                               num_epoch=1, device="cpu")])
    out = card.save_bundle(str(tmp_path / "bundle"))
    assert sorted(os.listdir(out)) == ["ENVIRONMENT.md", "punchcard.json",
                                       "run_punchcard.py"]
    entry = open(os.path.join(out, "run_punchcard.py")).read()
    assert "from distkeras_tpu_torch.job_deployment import Punchcard" in entry
    compile(entry, "run_punchcard.py", "exec")
    reloaded = Punchcard(path=os.path.join(out, "punchcard.json"))
    assert [j.to_spec() for j in reloaded.jobs] == \
        [j.to_spec() for j in card.jobs]
    results = reloaded.run()
    assert len(results) == 1 and results[0]["training_time"] > 0


def test_job_with_live_model_rejects_bundling():
    job = Job("live", "SingleTrainer", MLP(), _tiny_data, batch_size=64)
    with pytest.raises(TypeError, match="dotted"):
        job.to_spec()
    jjob = jjobs.Job("live", "SingleTrainer", object(), _tiny_data)
    with pytest.raises(TypeError, match="dotted"):
        jjob.to_spec()


def test_local_launcher_submit_poll_results(tmp_path):
    """A saved bundle runs in a fresh interpreter on the port, is polled
    to completion within a timeout, and its results come back."""
    card = Punchcard(jobs=[Job("launched-mnist", "SingleTrainer",
                               model=MODEL, data=DATA, batch_size=512,
                               num_epoch=1, device="cpu")])
    bundle = card.save_bundle(str(tmp_path / "bundle"))
    handle = LocalLauncher().submit(bundle)
    assert isinstance(handle, JobHandle)
    assert handle.poll() in ("RUNNING", "SUCCEEDED")
    status = handle.wait(timeout=240)
    log = handle.log_path if os.path.exists(handle.log_path) \
        else handle._log_tmp
    assert status == "SUCCEEDED", open(log).read()[-2000:]
    results = handle.results()
    assert len(results) == 1 and results[0]["job_name"] == "launched-mnist"
    assert results[0]["training_time"] > 0
    assert os.path.exists(handle.results_path)


def test_local_launcher_failed_job_surfaces_log(tmp_path):
    with pytest.raises(FileNotFoundError, match="bundle"):
        LocalLauncher().submit(str(tmp_path))  # not a bundle
    bundle = tmp_path / "bad"
    bundle.mkdir()
    (bundle / "run_punchcard.py").write_text(
        "import sys; print('dying', file=sys.stderr); sys.exit(3)\n")
    handle = LocalLauncher(python=sys.executable).submit(str(bundle))
    assert handle.wait(timeout=60) == "FAILED"
    with pytest.raises(RuntimeError, match="dying"):
        handle.results()


# -- parallel.distributed on one process ----------------------------------------

def test_process_info_and_host_address():
    from distkeras_tpu.parallel import distributed as jdistributed

    info = distributed.process_info()
    assert set(info) == {"process_index", "process_count", "local_devices",
                         "global_device_count", "host_address"}
    assert set(info) == set(jdistributed.process_info())
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["global_device_count"] >= 1
    assert isinstance(info["host_address"], str) and info["host_address"]


def test_multihost_mesh_single_process():
    mesh = distributed.multihost_mesh(num_workers=4, model_parallelism=2,
                                      devices=["cpu"] * 8)
    assert mesh.shape == {"workers": 4, "model": 2}
    assert mesh.device(3, 1) == torch.device("cpu")


def test_initialize_noop_and_single_process_group(monkeypatch):
    """No arguments and no launcher: a no-op. Explicit arguments join a
    one-process gloo group, after which meshes still build; in a group
    of several processes a mesh spans them (a worker row a process's
    device), the model axis included: a row a process when each passes
    two devices at model 2, a row over both when each passes one."""
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.initialize(num_processes=1)
    distributed.initialize(coordinator_address="127.0.0.1:0",
                           num_processes=1, process_id=0)
    try:
        assert torch.distributed.get_world_size() == 1
        assert mesh_lib.make_mesh(devices=["cpu"]).shape["workers"] == 1
        assert distributed.fold_group() == (None, None)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
        mesh = mesh_lib.make_mesh(devices=["cpu"])
        assert mesh.shape["workers"] == 2 and mesh.owners == [0, 1]
        assert mesh_lib.local_worker_positions(mesh) == [0]
        assert distributed.multihost_mesh(devices=["cpu"]).owners == [0, 1]
        rows = mesh_lib.make_mesh(devices=["cpu"] * 2, model_parallelism=2)
        assert rows.shape == {"workers": 2, "model": 2}
        assert rows.device_owners == [[0, 0], [1, 1]]
        assert mesh_lib.local_worker_positions(rows) == [0]
        span = distributed.multihost_mesh(devices=["cpu"],
                                          model_parallelism=2)
        assert span.shape == {"workers": 1, "model": 2}
        assert span.device_owners == [[0, 1]] and span.owners == [0]
        assert mesh_lib.local_worker_positions(span) == [0]
        assert span.row_processes == 2 and rows.row_processes == 1
    finally:
        monkeypatch.undo()
        torch.distributed.destroy_process_group()
    assert not torch.distributed.is_initialized()
