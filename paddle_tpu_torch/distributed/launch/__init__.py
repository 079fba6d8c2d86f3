"""The launcher's builtin KV store (the part of
``paddle_tpu/distributed/launch`` that ``distributed.rpc`` needs). The
multi-process launcher itself (``launch``, ``main``, ``Pod``) is not
ported."""
from .kv_server import KVClient, KVServer

__all__ = ["KVServer", "KVClient"]
