"""Launcher CLI: ``python -m paddle_tpu_torch.distributed.launch train.py``
(port of ``paddle_tpu/distributed/launch/main.py``).

Reference parity: ``python/paddle/distributed/launch/main.py:18`` +
``CollectiveController`` (``controllers/collective.py``) + elastic restart
(``fleet/elastic/manager.py:127``). Where the JAX reference runs one
worker per host (SPMD drives every local chip from one process), the port
runs one worker per card: ``--nproc_per_node`` workers on each node, each
binding ``cuda:PADDLE_LOCAL_RANK`` in ``env.init_parallel_env``.
``--devices_per_proc N`` (0 = off) gives each worker a block of ``N``
cards through ``CUDA_VISIBLE_DEVICES`` (worker ``i`` sees cards ``i*N ..
i*N+N-1``), where the reference gives each worker ``N`` virtual CPU
devices.

Env contract handed to workers (superset of the reference's):
  PADDLE_TRAINER_ID / RANK, PADDLE_LOCAL_RANK, PADDLE_TRAINERS_NUM /
  WORLD_SIZE, PADDLE_MASTER (the ``torch.distributed`` rendezvous
  address, host:port), PADDLE_JOB_ID, PADDLE_KV_ENDPOINT, PADDLE_ELASTIC.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import time
from typing import List, Optional

from .job import Container, Pod
from .kv_server import KVClient, KVServer
from ..resilience import EXIT_PREEMPTED

# preemption exits restart for free (they checkpointed under their grace
# deadline and resume exactly where they left off), but a worker that
# "preempts" in a tight loop is a bug, not the scheduler — cap the free
# restarts so it cannot spin forever
_MAX_PREEMPT_RESTARTS = 16


def _note_preemption(args, status: int) -> bool:
    """True when ``status`` is a supervisor checkpoint-and-exit that should
    restart WITHOUT charging --max_restarts (bounded per launcher)."""
    if status != EXIT_PREEMPTED:
        return False
    count = getattr(args, "_preempt_restarts", 0) + 1
    args._preempt_restarts = count
    if count > _MAX_PREEMPT_RESTARTS:
        print(f"[launch] {count} preemption exits — treating further ones "
              f"as failures", flush=True)
        return False
    print(f"[launch] worker preempted (exit {status}); restarting to resume "
          f"from checkpoint ({count}/{_MAX_PREEMPT_RESTARTS} free restarts)",
          flush=True)
    return True


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _host(args) -> str:
    """This node's address for its peers: loopback when ``--master`` is a
    loopback address (every node on this machine) or the host name does
    not resolve, else the host name's address."""
    master = (args.master or "").rsplit(":", 1)[0]
    if master in ("localhost", "::1") or master.startswith("127."):
        return "127.0.0.1"
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="paddle_tpu_torch multi-process launcher")
    p.add_argument("--nnodes", type=str, default="1",
                   help="node count; a min:max range enables ELASTIC mode: "
                        "membership is lease-based via the KV store, node "
                        "loss/arrival resizes the world between min and max "
                        "and restarts workers (resume from AutoCheckpoint)")
    p.add_argument("--elastic_ttl", type=float, default=6.0,
                   help="elastic lease TTL seconds (heartbeat every ttl/3)")
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", "0")))
    p.add_argument("--master", type=str,
                   default=os.environ.get("PADDLE_LAUNCH_MASTER"),
                   help="kv server endpoint host:port (node 0 hosts it)")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="workers per node (one per card)")
    p.add_argument("--devices_per_proc", type=int, default=0,
                   help="cards per worker through CUDA_VISIBLE_DEVICES "
                        "(0 = off: every worker sees every card)")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--max_restarts", type=int, default=0,
                   help="elastic: relaunch failed pods up to N times")
    p.add_argument("--job_id", type=str, default="default")
    p.add_argument("script", type=str, help="training script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p


def _worker_env(args, local_rank: int, world: int, rank: int,
                coordinator: str, kv_endpoint: Optional[str],
                elastic: bool = False) -> dict:
    # workers must resolve the same paddle_tpu_torch the launcher runs
    # from (python <script> does not add the launcher cwd to sys.path)
    import paddle_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(paddle_tpu_torch.__file__)))
    py_path = os.environ.get("PYTHONPATH", "")
    if pkg_root not in py_path.split(os.pathsep):
        py_path = pkg_root + (os.pathsep + py_path if py_path else "")
    env = {
        "PYTHONPATH": py_path,
        "PADDLE_TRAINER_ID": str(rank),
        "RANK": str(rank),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "WORLD_SIZE": str(world),
        "PADDLE_MASTER": coordinator,
        "PADDLE_JOB_ID": args.job_id,
    }
    if kv_endpoint:
        env["PADDLE_KV_ENDPOINT"] = kv_endpoint
    if elastic:
        # the worker-side hint that THIS world size is provisional: meshes
        # should be rebuilt per incarnation from the newest checkpoint's
        # recorded topology (distributed.elastic_mesh.reshaped_mesh), so a
        # resume on N-k nodes reshard-restores instead of demanding the
        # exact mesh that wrote the snapshot
        env["PADDLE_ELASTIC"] = "1"
    if args.devices_per_proc:
        n = args.devices_per_proc
        env["CUDA_VISIBLE_DEVICES"] = ",".join(
            str(local_rank * n + i) for i in range(n))
    return env


def launch(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    parts = args.nnodes.split(":")
    min_nodes = int(parts[0])
    max_nodes = int(parts[1]) if len(parts) > 1 else min_nodes
    elastic = max_nodes > min_nodes
    nproc = args.nproc_per_node
    world = min_nodes * nproc
    if not elastic and args.node_rank >= min_nodes:
        raise ValueError(
            f"--node_rank {args.node_rank} out of range for --nnodes "
            f"{min_nodes}")
    if args.master and ":" not in args.master:
        raise ValueError(f"--master must be host:port, got {args.master!r}")

    kv_server = None
    kv_endpoint = None
    if elastic or min_nodes > 1:
        # node 0 hosts the KV store; everyone rendezvous through it
        if args.node_rank == 0:
            port = (int(args.master.rsplit(":", 1)[1])
                    if args.master else _free_port())
            kv_server = KVServer(port).start()
            kv_endpoint = args.master or f"{_host(args)}:{port}"
        else:
            if not args.master:
                raise ValueError("--master required for node_rank > 0")
            kv_endpoint = args.master

    def rendezvous(attempt: int) -> str:
        """Per-attempt coordinator exchange. Keys are generation-scoped so a
        relaunched pod never picks up a dead incarnation's address; peer
        nodes converge on the new attempt once their own pod fails and
        re-enters here (failure detection is per-node: a peer notices via
        its collectives erroring, then its launcher restarts into the same
        attempt key)."""
        if min_nodes == 1:
            return f"127.0.0.1:{_free_port()}"
        key = f"{args.job_id}/coordinator/a{attempt}"
        kv = KVClient(kv_endpoint)
        if args.node_rank == 0:
            kv.put(key, f"{_host(args)}:{_free_port()}")
        return kv.wait(key)

    if elastic:
        try:
            return _launch_elastic(args, min_nodes, max_nodes, nproc,
                                   kv_endpoint)
        finally:
            if kv_server:
                kv_server.stop()

    attempt = 0   # failures charged against --max_restarts
    gen = 0       # rendezvous generation: bumps on EVERY relaunch
    coordinator = rendezvous(gen)
    try:
        while True:
            pod = _build_pod(args, args.node_rank, world, nproc, coordinator,
                             kv_endpoint)
            pod.deploy()
            try:
                status = pod.join(watcher_interval=30.0)
            finally:
                pod.terminate()  # idempotent; closes log fds
            if status == 0:
                print(f"[launch] job {args.job_id} finished", flush=True)
                return 0
            gen += 1
            if _note_preemption(args, status):
                # graceful checkpoint-and-exit (supervisor EXIT_PREEMPTED):
                # restart to resume from the recorded step WITHOUT charging
                # --max_restarts (bounded by _MAX_PREEMPT_RESTARTS)
                time.sleep(1.0)
                coordinator = rendezvous(gen)
                continue
            attempt += 1
            if attempt > args.max_restarts:
                print(f"[launch] job {args.job_id} FAILED (exit {status}) "
                      f"after {attempt - 1} restarts", flush=True)
                return status
            # restart: regenerate the coordinator (the old one is dead)
            # and go again — the ElasticManager relaunch path, minus etcd
            print(f"[launch] worker failed (exit {status}); restart "
                  f"{attempt}/{args.max_restarts}", flush=True)
            time.sleep(1.0)
            coordinator = rendezvous(gen)
    finally:
        if kv_server:
            kv_server.stop()


def _build_pod(args, node_rank: int, world: int, nproc: int,
               coordinator: str, kv_endpoint: Optional[str],
               elastic: bool = False) -> "Pod":
    """Shared by static and elastic paths so worker spawning can't drift."""
    pod = Pod()
    for local_rank in range(nproc):
        rank = node_rank * nproc + local_rank
        env = _worker_env(args, local_rank, world, rank, coordinator,
                          kv_endpoint, elastic=elastic)
        log = (os.path.join(args.log_dir, f"worker.{rank}.log")
               if args.log_dir else None)
        pod.add(Container(
            [sys.executable, "-u", args.script, *args.script_args],
            env, log))
    return pod


def _launch_elastic(args, min_nodes: int, max_nodes: int, nproc: int,
                    kv_endpoint: str) -> int:
    """Elastic supervision loop (``fleet/elastic/manager.py:127`` semantics
    over KV leases): membership -> ranks -> pod; a change in the ACTIVE set
    (first max_nodes members — later arrivals are spares) terminates the
    pod and re-enters rendezvous at the new world size; workers resume from
    AutoCheckpoint. Worker *failures* (not membership changes) count
    against --max_restarts."""
    import threading
    import uuid

    from .elastic import ElasticManager

    node_id = f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    mgr = ElasticManager(kv_endpoint, args.job_id, node_id,
                         ttl=args.elastic_ttl)
    mgr.register()
    restarts = 0
    coord_gen = 0  # newest coordinator generation we have used
    try:
        while True:
            try:
                done = mgr.kv.get(f"elastic/{args.job_id}/done")
            except OSError:
                done = None  # transient KV hiccup; proceed and retry later
            if done:
                # the job completed under another membership (we were a
                # spare, or raced the leader's exit) — don't resurrect it
                print(f"[launch] job {args.job_id} already finished",
                      flush=True)
                return 0
            members = mgr.wait_stable(min_nodes, max_nodes)
            active = members[:max_nodes]
            if node_id not in active:
                if node_id not in members:
                    raise RuntimeError("our own lease expired; clock stall?")
                # spare: hold until the active set has an opening
                print(f"[launch] standing by as spare "
                      f"({len(members)} nodes registered)", flush=True)
                while True:
                    members = mgr.watch(members, interval=args.elastic_ttl / 3)
                    if node_id in members[:max_nodes]:
                        break
                continue
            node_rank = active.index(node_id)
            world = len(active) * nproc
            if node_rank == 0:
                coordinator = f"{_host(args)}:{_free_port()}"
                coord_gen = mgr.publish_coordinator(coordinator, active)
            else:
                # gen must EXCEED the last one we used: a failure-restart
                # with unchanged membership needs a fresh coordinator, not
                # the dead one still in the KV
                coordinator, coord_gen = mgr.wait_coordinator(
                    active, min_gen=coord_gen + 1)
            print(f"[launch] elastic world: {len(active)} nodes x {nproc} "
                  f"procs (rank {node_rank})", flush=True)

            pod = _build_pod(args, node_rank, world, nproc, coordinator,
                             kv_endpoint, elastic=True)
            pod.deploy()

            # watch the ACTIVE set while the pod runs; on change, kill it
            resized = threading.Event()
            stop_watch = threading.Event()

            def health_watch():
                # surfaces silent heartbeat failure: if our own lease stops
                # refreshing, the rest of the cluster will resize us out in
                # one TTL — warn the operator BEFORE that happens
                while not stop_watch.wait(max(1.0, args.elastic_ttl / 2)):
                    if not mgr.is_healthy():
                        print(f"[launch] WARNING: elastic heartbeat "
                              f"unhealthy (last error: {mgr.last_error!r});"
                              f" lease may expire", flush=True)

            def watch():
                cur = members
                while not stop_watch.is_set():
                    cur = mgr.watch(cur, interval=args.elastic_ttl / 3.0,
                                    stop=stop_watch)
                    if stop_watch.is_set():
                        return
                    if cur[:max_nodes] != active:
                        resized.set()
                        pod.terminate()
                        return
                    # spare-only churn: keep watching, don't resize

            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            health = threading.Thread(target=health_watch, daemon=True)
            health.start()
            try:
                status = pod.join(watcher_interval=5.0)
            finally:
                stop_watch.set()
                pod.terminate()
            if resized.is_set():
                print("[launch] membership changed; resizing", flush=True)
                continue  # not a failure: re-rendezvous at new world
            if status == 0:
                print(f"[launch] job {args.job_id} finished", flush=True)
                if node_rank == 0:
                    # completion marker so spares don't resurrect the job.
                    # Leased (not permanent): it only needs to outlive the
                    # spares' watch wakeup, and a permanent key would make a
                    # REUSED job_id on a shared KV store return success
                    # without running anything.
                    try:
                        mgr.kv.put(f"elastic/{args.job_id}/done", "1",
                                   ttl=max(60.0, 10 * args.elastic_ttl))
                    except OSError:
                        pass
                return 0
            if _note_preemption(args, status):
                # self-reported checkpoint-and-exit: resume immediately,
                # no need to wait out a lease TTL diagnosing a dead peer
                continue
            # a worker failure is often the echo of a peer node dying: its
            # collectives error within seconds, long before the dead lease
            # expires (ttl). Wait one TTL and recheck membership BEFORE
            # charging max_restarts — peer loss must resize, not fail.
            time.sleep(args.elastic_ttl + 0.5)
            try:
                now_active = mgr.members()[:max_nodes]
            except OSError:
                now_active = active
            if now_active != active:
                print("[launch] membership changed; resizing", flush=True)
                continue
            restarts += 1
            if restarts > args.max_restarts:
                print(f"[launch] job {args.job_id} FAILED (exit {status}) "
                      f"after {restarts - 1} restarts", flush=True)
                return status
            print(f"[launch] worker failed (exit {status}); restart "
                  f"{restarts}/{args.max_restarts}", flush=True)
    finally:
        mgr.leave()


def main() -> None:
    sys.exit(launch())
