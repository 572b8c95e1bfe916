"""Observation for the port (``core/obs.py``): the span recorder of the
compute path, and the stager's latency window and logger from
``repro/core``."""
