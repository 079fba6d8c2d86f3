"""Federated-learning coordinator over the launch KV store (port of
``paddle_tpu/distributed/ps/coordinator.py``).

Reference parity: ``python/paddle/distributed/ps/coordinator.py`` —
``Coordinator`` + ``ClientSelector`` (round-based client selection from
reported ``ClientInfoAttr`` states) and ``FLClient`` (push state, pull the
coordinator's per-client ``FLStrategy``), all brpc-transported in the
reference.

Transport is the launch CLI's HTTP :class:`KVClient`
(the same rendezvous store elastic/launch already run), so an FL round is
plain KV traffic: clients PUT ``fl/state/<id>`` each round, the
coordinator reads all states, runs its selector, PUTs
``fl/strategy/<round>/<id>``, and clients WAIT on their key. No new
service process is needed — any KVServer (or the launch master) hosts it.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

from ..launch.kv_server import KVClient, KVServer

__all__ = ["ClientInfoAttr", "FLStrategy", "ClientSelector", "FLClient",
           "Coordinator"]


class ClientInfoAttr:
    """What a client reports each round (reference ``ClientInfoAttr``)."""

    def __init__(self, device_type: str = "cpu", compute_capacity: float = 1.0,
                 bandwidth: float = 1.0, loss: Optional[float] = None,
                 num_samples: int = 0):
        self.device_type = device_type
        self.compute_capacity = float(compute_capacity)
        self.bandwidth = float(bandwidth)
        self.loss = loss
        self.num_samples = int(num_samples)

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @classmethod
    def from_json(cls, s: str) -> "ClientInfoAttr":
        obj = cls()
        obj.__dict__.update(json.loads(s))
        return obj


class FLStrategy:
    """Coordinator's per-client decision (reference ``FLStrategy``):
    JOIN (train this round), WAIT (sit out), FINISH (stop)."""

    JOIN = "JOIN"
    WAIT = "WAIT"
    FINISH = "FINISH"

    def __init__(self, action: str = "JOIN", params: Optional[Dict] = None):
        self.action = action
        self.params = params or {}

    def to_json(self) -> str:
        return json.dumps({"action": self.action, "params": self.params})

    @classmethod
    def from_json(cls, s: str) -> "FLStrategy":
        d = json.loads(s)
        return cls(d["action"], d.get("params"))


class ClientSelector:
    """Default round selector (reference ``ClientSelector``): every
    reporting client JOINs until ``max_rounds``, then FINISH. Subclass /
    pass ``select_fn`` for capacity- or loss-aware selection."""

    def __init__(self, max_rounds: int = 10,
                 select_fn: Optional[Callable[[int, Dict[str, ClientInfoAttr]],
                                              Dict[str, FLStrategy]]] = None):
        self.max_rounds = int(max_rounds)
        self.select_fn = select_fn

    def select(self, round_idx: int,
               states: Dict[str, ClientInfoAttr]) -> Dict[str, FLStrategy]:
        if self.select_fn is not None:
            return self.select_fn(round_idx, states)
        action = (FLStrategy.FINISH if round_idx >= self.max_rounds - 1
                  else FLStrategy.JOIN)
        return {cid: FLStrategy(action) for cid in states}


class Coordinator:
    """Round loop: gather client states -> select -> publish strategies.

    ``run_round`` blocks until ``num_clients`` states for this round are
    present, then publishes one FLStrategy per client.
    """

    def __init__(self, endpoint: Optional[str] = None,
                 selector: Optional[ClientSelector] = None,
                 strategy_ttl: float = 600.0):
        self._server = None
        self._last_strategies: Dict[str, FLStrategy] = {}
        self.strategy_ttl = float(strategy_ttl)
        if endpoint is None:
            self._server = KVServer()
            self._server.start()
            endpoint = f"127.0.0.1:{self._server.port}"
        self.endpoint = endpoint
        self.kv = KVClient(endpoint)
        self.selector = selector or ClientSelector()

    def run_round(self, round_idx: int, num_clients: int,
                  timeout: float = 300.0) -> Dict[str, ClientInfoAttr]:
        deadline = time.time() + timeout
        prefix = f"fl/state/{round_idx}/"
        while True:
            found = self.kv.list(prefix)
            if len(found) >= num_clients:
                break
            if time.time() > deadline:
                raise TimeoutError(
                    f"fl round {round_idx}: {len(found)}/{num_clients} "
                    f"client states")
            time.sleep(0.05)
        states = {k[len(prefix):]: ClientInfoAttr.from_json(v)
                  for k, v in found.items()}
        strategies = self.selector.select(round_idx, states)
        for cid, strat in strategies.items():
            # TTL so strategy keys can never satisfy a FUTURE session's
            # wait on a long-lived shared KV endpoint
            self.kv.put(f"fl/strategy/{round_idx}/{cid}", strat.to_json(),
                        ttl=self.strategy_ttl)
        # state keys are consumed: delete so a rerun can't read stale info
        for k in found:
            self.kv.delete(k)
        self._last_strategies = strategies
        return states

    def run(self, num_clients: int, max_rounds: Optional[int] = None,
            timeout: float = 300.0) -> int:
        """Drive rounds until the selector FINISHes everyone; returns the
        number of rounds run."""
        rounds = max_rounds or self.selector.max_rounds
        # NOTE: no auto-reset — clients may legitimately have pushed round-0
        # states already. Staleness is prevented structurally: state keys
        # are deleted when consumed and strategy keys carry a TTL. Call
        # reset() explicitly when recovering a crashed session on a shared
        # endpoint.
        for r in range(rounds):
            self.run_round(r, num_clients, timeout=timeout)
            # act on the SAME decisions run_round published: re-invoking a
            # stateful/stochastic selector could diverge from what clients
            # were told
            if all(s.action == FLStrategy.FINISH
                   for s in self._last_strategies.values()):
                return r + 1
        return rounds

    def reset(self) -> None:
        """Purge every fl/ key (stale states/strategies from a previous
        session sharing this KV endpoint)."""
        for k in self.kv.list("fl/"):
            self.kv.delete(k)

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None


class FLClient:
    """Client half (reference ``FLClient``): push state, wait for this
    round's strategy. State keys carry a TTL so one that the coordinator
    never consumes (late pusher, crashed session) cannot satisfy a future
    session's round on a shared endpoint."""

    def __init__(self, client_id: str, endpoint: str,
                 state_ttl: float = 600.0):
        self.client_id = str(client_id)
        self.kv = KVClient(endpoint)
        self.state_ttl = float(state_ttl)

    def push_client_info(self, round_idx: int, info: ClientInfoAttr) -> None:
        self.kv.put(f"fl/state/{round_idx}/{self.client_id}", info.to_json(),
                    ttl=self.state_ttl)

    def pull_fl_strategy(self, round_idx: int,
                         timeout: float = 300.0) -> FLStrategy:
        key = f"fl/strategy/{round_idx}/{self.client_id}"
        val = self.kv.wait(key, timeout=timeout)
        return FLStrategy.from_json(val)
