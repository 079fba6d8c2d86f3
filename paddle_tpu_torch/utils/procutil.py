"""Subprocess lifetime hardening (port of ``paddle_tpu/utils/procutil.py``).

Server subprocesses (PS shards, graph shards, launcher workers) must not
outlive the process that spawned them: an aborted run once left eight
``graph_server`` processes alive for 16 hours.
Reference: the brpc server's parent supervision lives in
``paddle/fluid/distributed/ps/service/brpc_ps_server.cc`` (run_server is
tied to the trainer's lifetime); here the guarantee is enforced twice:

- :func:`pdeathsig_preexec` — ``prctl(PR_SET_PDEATHSIG, SIGKILL)`` in the
  child between fork and exec, so the kernel kills the child the moment
  its parent exits (survives execve; Linux only, no-op elsewhere).
- :func:`start_ppid_watchdog` — a daemon thread in the server process that
  exits when the parent disappears (``getppid() == 1``): the portable
  belt-and-braces for the PDEATHSIG race (parent dying before prctl runs)
  and for non-Linux hosts.
"""
from __future__ import annotations

import os
import signal
import threading

PR_SET_PDEATHSIG = 1  # linux/prctl.h

# resolve libc ONCE at import: preexec_fn runs between fork and exec where
# only async-signal-safe-ish work is allowed — an `import ctypes`/CDLL there
# can deadlock on the parent's import/malloc locks in multithreaded parents
try:
    import ctypes

    _libc_prctl = ctypes.CDLL(None, use_errno=True).prctl
except Exception:  # non-Linux / no libc: the ppid watchdog still covers us
    _libc_prctl = None


def pdeathsig_preexec(parent_pid: int | None = None):
    """Return a ``subprocess.Popen`` ``preexec_fn`` that ties the child's
    lifetime to its parent's. ``parent_pid`` (default: the caller) closes
    the fork->prctl race: if the parent already died and the child was
    reparented, exit immediately instead of living forever."""
    if parent_pid is None:
        parent_pid = os.getpid()

    def _preexec():
        if _libc_prctl is not None:
            _libc_prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
        if os.getppid() != parent_pid:
            os._exit(1)

    return _preexec


def start_ppid_watchdog(interval: float = 5.0) -> threading.Thread:
    """Start a daemon thread that force-exits this process once its parent
    is gone (reparented to init/subreaper). Call from server ``main()``s."""
    parent = os.getppid()

    def _watch():
        import time

        while True:
            time.sleep(interval)
            # reparenting (to init or a subreaper) means the parent died.
            # Do NOT test `ppid == 1` on its own: in containers the
            # legitimate spawner may itself be PID 1.
            if os.getppid() != parent:
                os._exit(2)

    th = threading.Thread(target=_watch, name="ppid-watchdog", daemon=True)
    th.start()
    return th
