"""Graph-shard server subprocess entrypoint (port of
``paddle_tpu/distributed/ps/graph_server.py``).

``python -m paddle_tpu_torch.distributed.ps.graph_server --port 0`` prints
``PORT <p>`` once bound, then serves until a client sends STOP — the graph
half of the reference's PS server loop (``graph_brpc_server.cc`` behind
``fleet.init_server()``/``run_server()``)."""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)

    from ...utils.procutil import start_ppid_watchdog
    from .graph import GraphServer

    # belt-and-braces with the launcher's PDEATHSIG: exit when the parent
    # disappears, so an aborted run can't leak shard servers
    start_ppid_watchdog()
    srv = GraphServer(port=args.port)
    print(f"PORT {srv.port}", flush=True)
    srv.wait()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
