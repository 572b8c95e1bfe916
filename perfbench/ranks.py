"""A cell over several cards: one process a card on this host, started
and watched by the run's own process, as ``torchrun`` would start them.

The launcher (:func:`launch`) starts ``n`` copies of a command with the
environment ``torchrun`` sets (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` on a free port of
this host, and ``OMP_NUM_THREADS`` 1 unless it is set: n processes whose
thread pools each spanned the host's cores would contend for them) and
the launcher's own start time.  Every line a rank writes
to standard error reaches the launcher's standard error with ``[rank r]``
in front; rank 0's standard output is printed once every rank has exited
with 0, and then the numbers compared with their limits (the result's
``check``) as the last lines of standard error.  A rank that exits with
another code ends the run: the others are killed, and the launcher exits
with that code and prints no result.  A killed launcher takes its ranks
with it.

Inside a rank: :func:`is_rank`, :func:`started_at`, :func:`join` (the
port's process group with a bounded timeout, so that a hang ends),
:func:`agree` (rank 0's decision, e.g. that the window has closed, taken
by every rank) and :func:`leave` (the rank's exit).
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta
from typing import List, Optional, Sequence

LAUNCHED_AT = "PERFBENCH_LAUNCHED_AT"  # the launcher's perf_counter at start
GROUP_TIMEOUT = timedelta(minutes=10)
_GRACE_S = 10.0


def is_rank() -> bool:
    """Whether this process is one rank of a launched run."""
    return LAUNCHED_AT in os.environ


def started_at() -> float:
    """The launcher's start on this process's ``perf_counter`` (Linux's
    monotonic clock, which every process on the host shares)."""
    return float(os.environ[LAUNCHED_AT])


def rank() -> int:
    return int(os.environ.get("RANK", 0))


def join(init_distributed) -> None:
    """Joins the run's process group through the port's
    ``init_distributed``, every group of it (the mesh's too) with the
    timeout ``GROUP_TIMEOUT``: a collective that waits longer fails its
    rank, and that ends the run."""
    import torch.distributed.distributed_c10d as c10d
    c10d.default_pg_timeout = GROUP_TIMEOUT
    c10d.default_pg_nccl_timeout = GROUP_TIMEOUT
    init_distributed()


def agree(decision: bool) -> bool:
    """Rank 0's ``decision``, on every rank of the default group (the
    decision itself where there is no group of more than one rank)."""
    import torch
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return decision
    flag = torch.tensor([int(decision)], dtype=torch.int32)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def leave(code: int) -> None:
    """Ends this rank with ``code`` once its streams are flushed, without
    the interpreter's teardown, where a library thread of the process
    group left joinable could abort the process (SIGABRT) after its work
    is done and its result printed."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """In the child before it runs: a SIGKILL when the launcher dies."""
    try:
        import ctypes
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def _relay(stream, out, prefix: str, keep: Optional[List[str]]) -> None:
    for line in iter(stream.readline, ""):
        if keep is not None:
            keep.append(line)
        else:
            out.write(prefix + line)
            out.flush()
    stream.close()


def _stop(procs: Sequence[subprocess.Popen]) -> None:
    """Ends every rank still running (SIGTERM, then SIGKILL) and waits for
    each."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    end = time.monotonic() + _GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _check_lines(out: str) -> List[str]:
    """The ``check`` of the result line (the last line of ``out``) as
    ``check <name>: <value> limit <limit>`` lines."""
    try:
        res = json.loads(out.strip().splitlines()[-1])
    except (IndexError, ValueError):
        return []
    return [f"check {k}: {c['value']!r} limit {c['limit']!r}\n"
            for k, c in (res.get("check") or {}).items()]


def launch(cmd: Sequence[str], n: int, t_start: float) -> int:
    """Runs ``cmd`` as ranks 0 .. n - 1 of one process group on this host
    (see the module doc); returns the run's exit code."""
    port = _free_port()
    procs: List[subprocess.Popen] = []
    threads: List[threading.Thread] = []
    out0: List[str] = []
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}

    def on_signal(signum, frame):
        raise SystemExit(128 + signum)
    for s in prev:
        signal.signal(s, on_signal)
    try:
        for r in range(n):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            env.setdefault("OMP_NUM_THREADS", "1")
            env[LAUNCHED_AT] = repr(t_start)
            procs.append(subprocess.Popen(
                list(cmd), env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, bufsize=1,
                preexec_fn=_die_with_parent))
        for r, p in enumerate(procs):
            for stream, keep in ((p.stderr, None),
                                 (p.stdout, out0 if r == 0 else None)):
                t = threading.Thread(target=_relay, daemon=True, args=(
                    stream, sys.stderr, f"[rank {r}] ", keep))
                t.start()
                threads.append(t)
        rc = 0
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad or None not in codes:
                rc = bad[0] if bad else 0
                break
            time.sleep(0.1)
        _stop(procs)
        rc = rc or next((p.returncode for p in procs if p.returncode), 0)
        for t in threads:
            t.join()
        if rc != 0:
            print(f"a rank exited with {rc}: the run has no result",
                  file=sys.stderr, flush=True)
            return rc if rc > 0 else 1
        text = "".join(out0)
        sys.stderr.writelines(_check_lines(text))
        sys.stderr.flush()
        sys.stdout.write(text)
        sys.stdout.flush()
        return 0
    finally:
        _stop(procs)
        for s, h in prev.items():
            signal.signal(s, h)
