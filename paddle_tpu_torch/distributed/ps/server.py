"""PS server subprocess entrypoint (port of
``paddle_tpu/distributed/ps/server.py``).

``python -m paddle_tpu_torch.distributed.ps.server --port 0 --embed-dim 8 ...``
prints ``PORT <p>`` once bound, then serves until a client sends STOP
(the reference's ``fleet.init_server(); fleet.run_server()`` loop,
``the_one_ps.py``). The package's import brings torch in, but the server
never initialises CUDA: it serves the native library's table over its
socket."""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--embed-dim", type=int, required=True)
    ap.add_argument("--optimizer", default="adagrad")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-shards", type=int, default=16)
    ap.add_argument("--load", default=None, help="snapshot to preload")
    args = ap.parse_args(argv)

    from ...utils.procutil import start_ppid_watchdog
    from .service import PsServer
    from .table import SparseAccessorConfig

    start_ppid_watchdog()
    srv = PsServer(SparseAccessorConfig(
        embed_dim=args.embed_dim, optimizer=args.optimizer,
        learning_rate=args.lr, seed=args.seed, num_shards=args.num_shards),
        port=args.port)
    if args.load:
        srv.table.load(args.load)
        srv.load_dense(args.load)  # dense sidecar (absent is fine)
    print(f"PORT {srv.port}", flush=True)
    srv.wait()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
