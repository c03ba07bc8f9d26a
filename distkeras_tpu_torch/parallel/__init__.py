"""Parallel plane of the port: the device mesh, the update rules of the
trainer zoo, the substrate that runs them (one process, K replicas), and
the wire format of ``parallel/remote_ps.py`` (the serving front end
speaks it)."""
