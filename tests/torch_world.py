"""A world of gloo ranks on loopback for the port's distributed tests.

``World(n)`` starts ``n`` fresh interpreters (never forks), each joining a
``torch.distributed`` world over gloo (``init_parallel_env(device=
"cpu")``) and a control connection back to the test process. ``run(name,
*args)`` runs ``torch_dist_tasks.<name>(*args)`` on every rank at once and
returns the ranks' results in rank order. Every wait has a deadline: a
rank that raises fails the call with its traceback, and a rank that hangs
or dies fails it after ``timeout`` seconds, after which the world is
killed (a later ``run`` raises at once). The ranks import torch and the
port, never jax.
"""
from __future__ import annotations

import os
import secrets
import signal
import socket
import subprocess
import sys
import time
from multiprocessing.connection import Client, Listener

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    def __init__(self, n: int, timeout: float = 120.0):
        self.n = n
        self.timeout = timeout
        self.dead = None
        key = secrets.token_bytes(16)
        self._listener = Listener(("127.0.0.1", 0), backlog=n, authkey=key)
        host, port = self._listener.address
        env = dict(os.environ, WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()),
                   TORCH_WORLD_CONTROL=f"{host}:{port}",
                   TORCH_WORLD_KEY=key.hex(), OMP_NUM_THREADS="1",
                   GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME",
                                                     "lo"),
                   PYTHONPATH=os.pathsep.join([REPO, TESTS]))
        self.procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import torch_world; torch_world.child_main()"],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=TESTS)
            for r in range(n)]
        self.conns = [None] * n
        deadline = time.monotonic() + timeout
        self._listener._listener._socket.settimeout(timeout)
        try:
            conns = [self._listener.accept() for _ in range(n)]
            for conn in conns:   # a rank reports once the world is up
                if not conn.poll(max(0.0, deadline - time.monotonic())):
                    raise TimeoutError("a rank did not join the world")
                self.conns[conn.recv()] = conn
        except BaseException:
            self.close()
            raise

    def run(self, name: str, *args, timeout: float = None):
        if self.dead is not None:
            raise RuntimeError(f"the world is down: {self.dead}")
        timeout = self.timeout if timeout is None else timeout
        for c in self.conns:
            c.send((name, args))
        deadline = time.monotonic() + timeout
        results, errors = [None] * self.n, []
        for r, c in enumerate(self.conns):
            try:
                if not c.poll(max(0.0, deadline - time.monotonic())):
                    for p in self.procs:   # each rank prints its stacks
                        if p.poll() is None:
                            p.send_signal(signal.SIGUSR1)
                    time.sleep(1.0)
                    raise TimeoutError(f"rank {r} did not answer {name} "
                                       f"within {timeout:.0f}s")
                status, value = c.recv()
            except (EOFError, OSError, TimeoutError) as e:
                self.dead = f"{type(e).__name__}: {e}"
                self.close()
                raise RuntimeError(f"{name}: {self.dead}") from e
            if status == "ok":
                results[r] = value
            else:
                errors.append(f"rank {r}:\n{value}")
        if errors:
            # a raising rank may leave its peers waiting in a collective
            # that never completes: the world cannot be trusted any more
            self.dead = f"{name} raised"
            self.close()
            raise RuntimeError(f"{name} failed\n" + "\n".join(errors))
        return results

    def close(self) -> None:
        for c in self.conns:
            if c is not None:
                try:
                    c.send(None)
                except OSError:
                    pass
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for c in self.conns:
            if c is not None:
                c.close()
        self._listener.close()


def child_main() -> None:
    import faulthandler
    import traceback

    faulthandler.register(signal.SIGUSR1)

    import torch

    torch.set_num_threads(1)
    host, port = os.environ["TORCH_WORLD_CONTROL"].rsplit(":", 1)
    conn = Client((host, int(port)),
                  authkey=bytes.fromhex(os.environ["TORCH_WORLD_KEY"]))
    rank = int(os.environ["RANK"])
    from paddle_tpu_torch.distributed import env

    env.init_parallel_env(device="cpu")
    conn.send(rank)
    import torch_dist_tasks

    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, args = msg
        try:
            conn.send(("ok", getattr(torch_dist_tasks, name)(*args)))
        except Exception:
            conn.send(("err", traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()
