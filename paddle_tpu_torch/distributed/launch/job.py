"""Process supervision: Container/Pod + watcher (port of
``paddle_tpu/distributed/launch/job.py``; framework-free, so copied).

Reference parity: ``python/paddle/distributed/launch/job/`` (``Job/Pod/
Container`` — env construction, spawn, status poll, log handling) and the
GPU-util ``Watcher`` (``controllers/watcher.py``). One Container = one
worker process; a Pod is this host's set of containers.
"""
from __future__ import annotations

import os
import subprocess
import time
from typing import Dict, List, Optional


class Container:
    """One supervised worker process."""

    def __init__(self, cmd: List[str], env: Dict[str, str],
                 log_path: Optional[str] = None):
        self.cmd = list(cmd)
        self.env = dict(env)
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self._log_file = None
        self.restarts = 0

    def start(self) -> None:
        if self.log_path:
            os.makedirs(os.path.dirname(os.path.abspath(self.log_path)),
                        exist_ok=True)
            self._log_file = open(self.log_path, "ab", buffering=0)
            out = self._log_file
        else:
            out = None
        from ...utils.procutil import pdeathsig_preexec

        self.proc = subprocess.Popen(
            self.cmd, env={**os.environ, **self.env},
            stdout=out, stderr=subprocess.STDOUT if out else None,
            preexec_fn=pdeathsig_preexec())

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def exit_code(self) -> Optional[int]:
        return None if self.proc is None else self.proc.poll()

    def terminate(self, grace: float = 10.0) -> None:
        if self.proc is None or self.proc.poll() is not None:
            return
        self.proc.terminate()
        try:
            self.proc.wait(grace)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()

    def close(self):
        if self._log_file:
            self._log_file.close()
            self._log_file = None


class Pod:
    """This host's containers + supervision loop (reference ``job/pod.py``)."""

    def __init__(self):
        self.containers: List[Container] = []

    def add(self, container: Container) -> None:
        self.containers.append(container)

    def deploy(self) -> None:
        for c in self.containers:
            c.start()

    def poll(self) -> Optional[int]:
        """None while all alive; first nonzero exit code on failure; 0 when
        every container exited cleanly."""
        codes = [c.exit_code for c in self.containers]
        for code in codes:
            if code not in (None, 0):
                return code
        if all(code == 0 for code in codes):
            return 0
        return None

    def join(self, poll_interval: float = 0.5,
             watcher_interval: float = 0.0) -> int:
        """Supervise until finish/failure. Returns final status code."""
        last_watch = time.time()
        while True:
            status = self.poll()
            if status is not None:
                if status != 0:
                    self.terminate()
                return status
            if watcher_interval and time.time() - last_watch > watcher_interval:
                alive = sum(c.alive for c in self.containers)
                print(f"[launch][watcher] {alive}/{len(self.containers)} "
                      f"workers alive", flush=True)
                last_watch = time.time()
            time.sleep(poll_interval)

    def terminate(self) -> None:
        for c in self.containers:
            c.terminate()
        for c in self.containers:
            c.close()
