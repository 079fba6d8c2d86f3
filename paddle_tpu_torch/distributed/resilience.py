"""Unified fault-tolerance layer (port of
``paddle_tpu/distributed/resilience.py``; framework-free, so copied and
adapted).

- :class:`RetryPolicy` — exponential backoff with jitter, an optional
  attempt cap and an optional wall-clock deadline, and a retryable-exception
  filter; ``policy.call(fn)`` is the retry loop, and :class:`Unavailable`
  lets poll loops ("not there yet") ride the same machinery as transport
  failures.
- :class:`Deadline` and :func:`with_timeout` — one wall-clock budget, and a
  blocking call bounded by it (worker thread + join; the thread is
  abandoned on timeout).
- :class:`FaultPlan` — deterministic fault injection. A plan is a list of
  :class:`FaultRule`\\ s keyed by call-site tag; the checkpoint writer
  tags ``ckpt.shard_write`` / ``ckpt.publish`` and the supervised fit loop
  ``train.step`` / ``train.ckpt`` / ``train.data`` (a ``drop`` at
  ``train.data`` poisons the batch through the step's NaN seam, a
  ``delay`` at ``train.step`` stalls it, a ``crash`` anywhere exits like a
  SIGKILL). Kinds: ``drop`` (raise :class:`InjectedFault`, a
  ``ConnectionError``), ``delay``, ``slow`` (a seeded-random delay),
  ``crash`` (``os._exit(CRASH_EXIT)``), ``partition`` (a contiguous
  outage window) and ``bitflip`` (raise :class:`InjectedBitflip`; its
  realiser, the cross-replica integrity vote, is not ported, so the
  supervised loop treats it as a ``drop``). All randomness is seeded per
  rule, so a plan replays identically. Activating a plan (``with plan:``)
  also exports it via ``PT_FAULT_PLAN`` so subprocesses inherit it.

The ``EXIT_*`` codes are the supervisor's process exit codes, the same
numbers as the reference's.
"""
from __future__ import annotations

import fnmatch
import json
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Type, Union

__all__ = [
    "RetryPolicy", "Unavailable", "with_timeout", "Deadline",
    "FaultPlan", "FaultRule", "InjectedFault", "InjectedBitflip",
    "fault_point", "active_plan", "CRASH_EXIT", "FAULT_PLAN_ENV",
    "EXIT_PREEMPTED", "EXIT_HANG", "EXIT_EVICTED",
]

# Exit codes of the self-healing training layer (framework/supervisor.py).
# ``distributed.launch`` recognises them: a worker that exits with
# EXIT_PREEMPTED checkpointed cleanly under its grace deadline and is
# restarted WITHOUT charging --max_restarts (resume lands on the recorded
# step via AutoCheckpoint + the data cursor); EXIT_HANG is the hang
# watchdog's hard exit after a step exceeded step_timeout (restart charges
# the budget — a hang may be a real bug, not an infra blip).
EXIT_PREEMPTED = 44
EXIT_HANG = 45
# the integrity escalation ladder convicted a host of sticky silent data
# corruption (distributed/integrity.py): the quarantine record is already
# durable next to the checkpoints, and the launcher restarts the job on the
# surviving capacity — elastic_mesh absorbs the shrink like a preemption,
# but the restart DOES charge the budget (a conviction names real hardware)
EXIT_EVICTED = 46


class Deadline:
    """A monotonic wall-clock budget stamped once at creation (the same
    single-budget discipline ``bench.py``'s supervisor applies to its
    probe + bench retries). The serving scheduler stamps one per request
    at submit: a request that waits out its budget in the queue is
    expired with ``TimeoutError``, never admitted.
    """

    __slots__ = ("expires_at", "total")

    def __init__(self, seconds: float):
        self.total = float(seconds)
        self.expires_at = time.monotonic() + self.total

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def __repr__(self):
        return f"Deadline(remaining={self.remaining():.3f}s)"


class Unavailable(ConnectionError):
    """A resource is not ready yet (missing KV key, absent peer). Raised by
    poll-style callables run under a :class:`RetryPolicy` so "not there
    yet" retries exactly like a transport failure."""


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter with an attempt cap and/or deadline.

    Give-up semantics: exhausting ``max_attempts`` re-raises the last
    underlying exception (callers keep their original error types);
    exceeding ``deadline`` raises :class:`TimeoutError` chained to the last
    failure. ``jitter`` is a +/- fraction of each delay; with ``seed`` set
    the jitter sequence is deterministic (fault-injection tests replay
    byte-identical schedules).
    """

    max_attempts: Optional[int] = None   # None = unlimited (deadline bounds)
    deadline: Optional[float] = None     # total seconds across all attempts
    base_delay: float = 0.2
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.0
    retryable: Tuple[Type[BaseException], ...] = (ConnectionError, OSError)
    seed: Optional[int] = None

    def __post_init__(self):
        if self.max_attempts is None and self.deadline is None:
            raise ValueError("RetryPolicy needs max_attempts or deadline "
                             "(an unbounded retry loop hides dead peers)")

    def delays(self):
        """The backoff schedule (unbounded generator; deterministic given
        ``seed``)."""
        rng = random.Random(self.seed)
        delay = self.base_delay
        while True:
            d = delay
            if self.jitter:
                d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
            yield max(0.0, d)
            delay = min(delay * self.multiplier, self.max_delay)

    def call(self, fn: Callable, *args,
             what: str = "operation",
             on_retry: Optional[Callable[[int, BaseException, float], None]]
             = None, **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying ``retryable`` failures.

        ``on_retry(attempt, exc, sleep)`` fires before each backoff sleep —
        the hook where callers drop poisoned connections.
        """
        start = time.monotonic()
        schedule = self.delays()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except self.retryable as e:
                elapsed = time.monotonic() - start
                if (self.max_attempts is not None
                        and attempt >= self.max_attempts):
                    raise
                if (self.deadline is not None
                        and elapsed >= self.deadline):
                    raise TimeoutError(
                        f"{what} still failing after {attempt} attempts / "
                        f"{elapsed:.1f}s (deadline {self.deadline}s): "
                        f"{e}") from e
                sleep = next(schedule)
                if self.deadline is not None:
                    sleep = min(sleep,
                                max(0.0, self.deadline - elapsed))
                if on_retry is not None:
                    on_retry(attempt, e, sleep)
                time.sleep(sleep)

    def until(self, poll: Callable[[], Optional[object]],
              what: str = "condition"):
        """Retry ``poll`` until it returns a non-``None`` value. ``None``
        results and transport failures both back off through this policy —
        the TCPStore ``wait`` shape."""
        def step():
            out = poll()
            if out is None:
                raise Unavailable(f"{what} not ready")
            return out
        return self.call(step, what=what)


def with_timeout(fn: Callable, timeout: float, what: str = "operation"):
    """Run ``fn()`` bounded by ``timeout`` seconds.

    Runs on a daemon worker thread and joins it; on timeout the thread is
    ABANDONED (python threads cannot be killed), so wrap only calls that
    are safe to orphan — shutdown barriers, best-effort teardown RPCs.
    Raises :class:`TimeoutError` on timeout, else returns/raises what
    ``fn`` did.
    """
    out: List[object] = []
    err: List[BaseException] = []

    def run():
        try:
            out.append(fn())
        except BaseException as e:
            err.append(e)

    t = threading.Thread(target=run, daemon=True, name=f"timeout:{what}")
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise TimeoutError(f"{what} did not finish within {timeout}s")
    if err:
        raise err[0]
    return out[0]


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

FAULT_PLAN_ENV = "PT_FAULT_PLAN"
# the exit code of an injected crash — tests and the sweep runner assert on
# it to tell "the plan killed the process" from a genuine failure
CRASH_EXIT = 43


class InjectedFault(ConnectionError):
    """An injected ``drop``/``partition`` fault. Subclasses
    ``ConnectionError`` so every production retry path treats it exactly
    like a real transport failure."""


class InjectedBitflip(InjectedFault):
    """An injected ``bitflip`` fault: the raising site's OWNER must flip
    one bit of tensor ``tensor`` in the physical copies held by vote-axis
    rank ``rank`` (``distributed.integrity.apply_bitflip`` is the
    canonical realiser). ``draw`` is a per-activation seeded integer —
    the realiser derives every remaining choice (which matching tensor,
    which element, which bit) from it, so a plan replays the identical
    corruption. Subclasses :class:`InjectedFault` so a site without
    tensor context degrades to an ordinary transport-failure drop."""

    def __init__(self, message: str, *, tensor: Optional[str] = None,
                 rank: int = 0, bit: Optional[int] = None, draw: int = 0):
        super().__init__(message)
        self.tensor = tensor
        self.rank = int(rank)
        self.bit = bit
        self.draw = int(draw)


@dataclass
class FaultRule:
    """One fault at matching call sites.

    ``site`` is an ``fnmatch`` pattern over the tag passed to
    :func:`fault_point` (``"kv.*"``, ``"ps.request.0"``). ``after`` skips
    the first N matching calls; ``times`` caps how often the rule fires
    (``None`` = unlimited). ``prob`` fires probabilistically from a per-rule
    seeded RNG, so the hit sequence is a pure function of (seed, call
    order). Kinds:

    - ``drop``: raise :class:`InjectedFault`.
    - ``delay``: sleep ``delay`` seconds, then let the call proceed.
    - ``slow``: sleep a seeded-random duration in ``[0.5, 1.5) * delay``,
      then let the call proceed — latency injection for gray-failure
      drills (the sequence of durations is a pure function of the rule's
      seed, so a slow-replica soak replays identically).
    - ``crash``: ``os._exit(CRASH_EXIT)`` — no cleanup, like SIGKILL.
    - ``partition``: every matching call in ``[after, after+times)`` fails
      (contiguous outage window; ``times=None`` = never heals).
    - ``bitflip``: raise :class:`InjectedBitflip` carrying ``tensor``
      (fnmatch pattern over parameter names), ``rank`` (vote-axis rank
      whose physical copies get corrupted) and ``bit`` (``None`` = seeded
      draw) — silent-data-corruption injection. The site's owner realises
      the flip (``integrity.apply_bitflip``); ``times=1`` models a
      transient cosmic-ray hit, ``times=None`` a sticky lying chip.
    """

    site: str
    kind: str
    times: Optional[int] = 1
    prob: float = 1.0
    delay: float = 0.05
    after: int = 0
    tensor: Optional[str] = None   # bitflip: parameter-name pattern
    rank: int = 0                  # bitflip: vote-axis rank to corrupt
    bit: Optional[int] = None      # bitflip: fixed bit (None = seeded)

    _KINDS = ("drop", "delay", "slow", "crash", "partition", "bitflip")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {self._KINDS}")


class FaultPlan:
    """A seeded, replayable set of :class:`FaultRule`\\ s.

    Use as a context manager in tests::

        plan = FaultPlan([{"site": "kv.get", "kind": "drop", "times": 2}],
                         seed=7)
        with plan:            # installs globally + exports PT_FAULT_PLAN
            ...               # subprocesses spawned here inherit the plan

    ``fired`` counts per-rule activations — tests assert the plan actually
    exercised the path they meant to break.
    """

    def __init__(self, rules: Sequence[Union[FaultRule, dict]],
                 seed: int = 0):
        self.rules: List[FaultRule] = [
            r if isinstance(r, FaultRule) else FaultRule(**r) for r in rules]
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._seen = [0] * len(self.rules)   # matching calls per rule
        self.fired = [0] * len(self.rules)   # activations per rule
        self._rngs = [random.Random(self.seed * 1_000_003 + i)
                      for i in range(len(self.rules))]
        self._prev: Optional[Tuple[Optional["FaultPlan"], Optional[str]]] = None

    # -- (de)serialisation: the subprocess-inheritance channel -------------
    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "rules": [{"site": r.site, "kind": r.kind, "times": r.times,
                       "prob": r.prob, "delay": r.delay, "after": r.after,
                       **({"tensor": r.tensor, "rank": r.rank,
                           "bit": r.bit} if r.kind == "bitflip" else {})}
                      for r in self.rules]})

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        data = json.loads(raw)
        return cls(data["rules"], seed=data.get("seed", 0))

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        raw = os.environ.get(FAULT_PLAN_ENV)
        return cls.from_json(raw) if raw else None

    # -- activation --------------------------------------------------------
    def install(self, env: bool = True) -> "FaultPlan":
        """Make this the process-wide active plan; with ``env`` the plan is
        also exported so subprocesses inherit it."""
        global _active
        self._prev = (_active, os.environ.get(FAULT_PLAN_ENV))
        _active = self
        if env:
            os.environ[FAULT_PLAN_ENV] = self.to_json()
        return self

    def uninstall(self) -> None:
        global _active
        prev_plan, prev_env = self._prev or (None, None)
        _active = prev_plan
        if prev_env is None:
            os.environ.pop(FAULT_PLAN_ENV, None)
        else:
            os.environ[FAULT_PLAN_ENV] = prev_env
        self._prev = None

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    # -- the hook ----------------------------------------------------------
    def check(self, site: str) -> None:
        """Evaluate every rule against one call at ``site`` (called from
        :func:`fault_point`). Raises/sleeps/exits per the first firing
        drop/partition rule; delay rules stack."""
        for i, rule in enumerate(self.rules):
            if not fnmatch.fnmatchcase(site, rule.site):
                continue
            with self._lock:
                n = self._seen[i]
                self._seen[i] += 1
                if n < rule.after:
                    continue
                if rule.kind == "partition":
                    if rule.times is not None and n >= rule.after + rule.times:
                        continue
                elif rule.times is not None and self.fired[i] >= rule.times:
                    continue
                if rule.prob < 1.0 and self._rngs[i].random() >= rule.prob:
                    continue
                self.fired[i] += 1
                # the RNG lives under the lock (prob draws share it);
                # the sleep itself happens after release
                sleep_s = rule.delay
                draw = 0
                if rule.kind == "slow":
                    sleep_s = rule.delay * (0.5 + self._rngs[i].random())
                elif rule.kind == "bitflip":
                    draw = self._rngs[i].randrange(1 << 31)
            if rule.kind in ("delay", "slow"):
                time.sleep(sleep_s)
            elif rule.kind == "crash":
                os._exit(CRASH_EXIT)
            elif rule.kind == "bitflip":
                raise InjectedBitflip(
                    f"injected bitflip at {site} "
                    f"(rule {i}, hit {self.fired[i]}, rank {rule.rank})",
                    tensor=rule.tensor, rank=rule.rank, bit=rule.bit,
                    draw=draw)
            else:  # drop / partition
                raise InjectedFault(
                    f"injected {rule.kind} at {site} "
                    f"(rule {i}, hit {self.fired[i]})")


_active: Optional[FaultPlan] = None
_env_checked = False


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, lazily loading ``PT_FAULT_PLAN`` on first use —
    subprocesses spawned under an active plan inherit it without any code
    on their side."""
    global _active, _env_checked
    if _active is None and not _env_checked:
        _env_checked = True
        _active = FaultPlan.from_env()
    return _active


def fault_point(site: str) -> None:
    """Instrumentation hook. Call sites tag themselves
    (``fault_point("kv.put")``); with no active plan this is two attribute
    loads and a comparison — cheap enough for hot paths."""
    plan = _active if _env_checked or _active is not None else active_plan()
    if plan is not None:
        plan.check(site)
