"""Parallel plane of the port: the workers x model device mesh, the
update rules of the trainer zoo, the substrate that runs them (one
process, K replicas), tensor parallelism (``tensor.py``: partition
rules and ``PjitTrainer``'s step) with its bucketed folds
(``collectives.py``), the one-process parts of ``distributed.py``, and
the wire format of ``parallel/remote_ps.py`` (the serving front end
speaks it)."""
