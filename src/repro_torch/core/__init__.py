"""What the port's carousel needs from ``repro/core``: the stager's
latency window and its logger (``core/obs.py``)."""
