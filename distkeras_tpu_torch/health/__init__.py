"""Health plane of the port: the flight recorder and the introspection
ops the serving wire mounts (``status``, ``metrics-snapshot``,
``recent-spans``, ``series``)."""
