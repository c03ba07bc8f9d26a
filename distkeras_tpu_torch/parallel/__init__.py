"""Parallel plane of the port: so far only the wire format of
``parallel/remote_ps.py`` (the serving front end speaks it)."""
