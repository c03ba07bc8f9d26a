"""Parallel plane of the port: the workers x model device mesh, the
update rules of the trainer zoo, the substrate that runs them (K
replicas, in one process or over several), tensor parallelism (``tensor.py``: partition
rules and ``PjitTrainer``'s step) with its bucketed folds
(``collectives.py``), sequence parallelism over ring attention
(``sequence.py``: ``make_sp_mesh``, ``build_sp_train_step``), pipeline
parallelism (``pipeline.py``: ``make_pp_mesh``, ``PipelinedLM``,
``GenericPipeline``), the process group of ``distributed.py`` (meshes,
folds and the live center over several processes), and the wire format
of ``parallel/remote_ps.py`` (the serving front end speaks it). The
module names are the JAX package's."""
