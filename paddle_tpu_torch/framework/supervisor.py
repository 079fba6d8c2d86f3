"""Self-healing training: numerics watchdog, auto-rollback, hang and
preemption supervision around a training step (port of
``paddle_tpu/framework/supervisor.py``).

- :class:`NumericsWatchdog` — consumes the LAZY ``(loss, ok, found_inf)``
  device flags a ``TrainStep.watchdog_call`` returns and reads them back in
  batches of ``check_interval`` steps (one host sync a window). An
  anomalous step was already skipped on the device (the guarded update
  keeps the old state); the watchdog's job is bookkeeping and escalation:
  ``max_consecutive`` anomalies in a row escalate from skip-step to
  rollback. GradScaler overflow skips are recognised (``found_inf``) and
  NOT counted as anomalies.
- auto-rollback — :class:`TrainingSupervisor` restores the newest VALID
  ``AutoCheckpoint`` (crc-verified) and hands back the checkpoint's
  :class:`~paddle_tpu_torch.io.cursor.DataCursor` so the caller replays
  the same data trajectory; ``skip_window`` additionally jumps the
  offending batches.
- :class:`HangWatchdog` — a daemon thread that fires when no step
  heartbeat lands within ``step_timeout``; ``action="exit"`` hard-exits
  with ``EXIT_HANG`` for a launcher to restart the worker from the last
  checkpoint.
- :class:`PreemptionHandler` — SIGTERM handler that requests a
  checkpoint-and-exit bounded by a ``resilience.Deadline`` grace window;
  the in-loop check raises :class:`TrainingPreempted` after the state (and
  cursor) is durably saved. ``uninstall()`` puts the previous handler back.

Fault sites: the loop is instrumented with ``train.step`` / ``train.ckpt``
/ ``train.data`` (``distributed.resilience.FaultPlan``): a ``drop`` at
``train.data`` poisons the next batch through the step's NaN seam, a
``delay`` at ``train.step`` stalls it.

Observability, as the reference names it: profiler counters
``train.scaler_skip``, ``train.anomaly``, ``train.hang``,
``train.reshard``, ``train.batch_skip``, ``train.rollback`` and
``train.preemption``; ``RecordEvent`` ranges ``watchdog_sync``,
``rollback`` and ``preempt_ckpt``; tracing events ``train:anomaly`` and
``train:rollback``; flight-recorder notes (``train_anomaly``) and dumps
(``hang``, ``rollback``, ``preemption``). ``before_batch`` mints each
step's correlation id (``train-<pid>-s<count>``), so the spans and dumps
of a step carry it. The counts are also attributes
(``NumericsWatchdog.anomalies`` / ``scaler_skips``,
``HangWatchdog.hangs_detected``, ``TrainingSupervisor.rollbacks`` /
``skipped_batches``).

Not ported here: the cross-replica integrity vote
(``integrity_check_interval``; ROADMAP A8) raises ``NotImplementedError``,
and a ``bitflip`` rule at ``train.bitflip`` degrades to the NaN seam.
"""
from __future__ import annotations

import os
import signal
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Callable, List, Optional, Set, Tuple

import torch

from .. import profiler
from ..distributed.resilience import (  # noqa: F401  (EXIT_* re-exported)
    Deadline, EXIT_EVICTED, EXIT_HANG, EXIT_PREEMPTED, InjectedFault,
    fault_point)
from ..observability import flight as _flight
from ..observability import tracing as _tracing
from ..profiler import RecordEvent

__all__ = [
    "RecoveryPolicy", "TrainingSupervisor", "NumericsWatchdog",
    "HangWatchdog", "PreemptionHandler", "TrainingPreempted",
    "RollbackRequested", "EXIT_PREEMPTED", "EXIT_HANG", "EXIT_EVICTED",
]


class TrainingPreempted(RuntimeError):
    """Raised at a step boundary after a SIGTERM/preemption request once the
    state has been checkpointed (or the grace deadline expired). The caller
    decides whether to re-raise, return, or ``sys.exit(EXIT_PREEMPTED)``."""

    def __init__(self, message: str, global_step: int, saved: bool):
        super().__init__(message)
        self.global_step = global_step
        self.saved = saved


class RollbackRequested(RuntimeError):
    """Control-flow signal: the watchdog escalated to rollback. The state
    has already been restored from the checkpoint; ``cursor`` (may be
    ``None`` when no checkpoint existed — continue in place) says where to
    resume the data stream and ``skip`` which ``(epoch, batch_index)``
    batches to jump."""

    def __init__(self, cursor, skip: Set[Tuple[int, int]]):
        super().__init__("numerics watchdog requested rollback")
        self.cursor = cursor
        self.skip = skip


@dataclass
class RecoveryPolicy:
    """Configuration for :class:`TrainingSupervisor` /
    ``Model.fit(recovery=...)``.

    - ``checkpoint_dir``: AutoCheckpoint root (``step_N`` dirs).
    - ``save_interval_steps``: snapshot every N optimizer steps.
    - ``check_interval``: watchdog host-sync batching (1 = every step).
    - ``max_consecutive``: K consecutive anomalous (skipped) steps escalate
      to rollback.
    - ``skip_window``: batches to jump past the first offending batch after
      a rollback (0 = replay everything and hope the anomaly was
      transient).
    - ``max_rollbacks``: give up (raise) after this many rollbacks.
    - ``step_timeout``: hang watchdog threshold in seconds (None = off).
    - ``hang_action``: ``"warn"`` logs and counts; ``"exit"`` hard-exits
      with ``EXIT_HANG`` for the launcher to restart.
    - ``preemption``: install the SIGTERM checkpoint-and-exit handler.
    - ``grace_seconds``: preemption grace budget (``resilience.Deadline``).
    - ``async_save``: overlap checkpoint IO with training (sync saves make
      kill-based tests deterministic).
    - ``integrity_check_interval``: silent-data-corruption defense —
      cross-replica fingerprint vote every N checked steps (``None`` =
      off, the default; any other value raises until the vote is ported,
      ROADMAP A8).
    - ``integrity_vote_axis``: mesh axis along which state must be
      bit-identical across replicas (leaves sharded over it — ZeRO
      shards — are excluded with coverage accounting).
    - ``integrity_forgive_after``: clean flushes after a replay before
      the armed suspect is forgiven as a transient fault.
    - ``integrity_ledger``: write/verify the per-save fingerprint record
      (``integrity.json``) next to ``metadata.json``.
    """

    checkpoint_dir: str
    save_interval_steps: int = 50
    keep_max: int = 3
    async_save: bool = True
    check_interval: int = 4
    max_consecutive: int = 2
    skip_window: int = 0
    max_rollbacks: int = 8
    step_timeout: Optional[float] = None
    hang_action: str = "warn"
    preemption: bool = True
    grace_seconds: float = 30.0
    integrity_check_interval: Optional[int] = None
    integrity_vote_axis: str = "dp"
    integrity_forgive_after: int = 2
    integrity_ledger: bool = True


def _read_back(flags):
    """``[(loss, ok, found), ...]`` as host floats, in one device-to-host
    copy when they are tensors on one device."""
    leaves = [x for triple in flags for x in triple]
    if leaves and all(isinstance(x, torch.Tensor) for x in leaves):
        host = torch.stack([x.detach().float().reshape(())
                            for x in leaves]).cpu().tolist()
    else:
        host = [float(x) for x in leaves]
    return [tuple(host[i:i + 3]) for i in range(0, len(host), 3)]


class NumericsWatchdog:
    """Batches the lazy per-step numerics flags and decides escalation."""

    def __init__(self, check_interval: int = 4, max_consecutive: int = 2):
        self.check_interval = max(1, int(check_interval))
        self.max_consecutive = max(1, int(max_consecutive))
        self._pending: List[tuple] = []  # (epoch, batch_index, loss, ok, found)
        self.consecutive = 0
        self.anomalies = 0
        self.scaler_skips = 0
        self.first_bad: Optional[Tuple[int, int]] = None  # start of the run

    def observe(self, epoch: int, batch_index: int, loss, ok, found) -> None:
        """Record one step's flags WITHOUT forcing them to host."""
        self._pending.append((epoch, batch_index, loss, ok, found))

    @property
    def due(self) -> bool:
        return len(self._pending) >= self.check_interval

    def flush(self) -> List[Tuple[int, int, float]]:
        """Host-sync every pending flag; returns the newly-found anomalies
        as ``(epoch, batch_index, loss)``. Escalation state (``consecutive``
        / ``first_bad``) is updated as a side effect. The moment the streak
        reaches ``max_consecutive`` the scan stops — later flags in the
        window describe steps the rollback is about to replay anyway."""
        todo = [(e, bi, loss, ok, found)
                for e, bi, loss, ok, found in self._pending
                if ok is not None]   # accumulate-only calls: nothing to judge
        self._pending.clear()
        if not todo:
            return []
        # ONE read-back for the whole window — per-flag bool() would cost
        # up to 2*check_interval serialized host round-trips per flush,
        # defeating the batched-sync design
        fetched = _read_back([(loss, ok, found)
                              for _, _, loss, ok, found in todo])
        out: List[Tuple[int, int, float]] = []
        for (epoch, bi, *_), (loss, ok, found) in zip(todo, fetched):
            if bool(found):          # GradScaler inf-skip: benign dynamics —
                self.scaler_skips += 1   # it also BREAKS an anomaly streak
                profiler.bump_counter("train.scaler_skip")
                self.consecutive = 0
                self.first_bad = None
                continue
            if bool(ok):
                self.consecutive = 0
                self.first_bad = None
                continue
            self.anomalies += 1
            profiler.bump_counter("train.anomaly")
            if self.consecutive == 0:
                self.first_bad = (epoch, bi)
            self.consecutive += 1
            out.append((epoch, bi, float(loss)))
            if self.consecutive >= self.max_consecutive:
                break
        return out

    @property
    def should_rollback(self) -> bool:
        return self.consecutive >= self.max_consecutive


class HangWatchdog:
    """Detects a train step exceeding ``step_timeout`` between heartbeats.

    The watcher runs on a daemon thread; :meth:`beat` is called at every
    step boundary. A stall fires ONCE per incident (re-armed by the next
    beat): ``on_hang(elapsed)`` then either a warning (``action="warn"``)
    or ``os._exit(EXIT_HANG)`` (``action="exit"``) — a hung kernel or
    collective cannot be interrupted from Python, so escaping means dying
    hard and letting a launcher restart from the last checkpoint.
    """

    def __init__(self, step_timeout: float, action: str = "warn",
                 on_hang: Optional[Callable[[float], None]] = None):
        if action not in ("warn", "exit"):
            raise ValueError(f"hang action must be 'warn' or 'exit', got {action!r}")
        self.step_timeout = float(step_timeout)
        self.action = action
        self.on_hang = on_hang
        self.hangs_detected = 0
        self._last_beat = time.monotonic()
        self._fired = False
        self._paused = True
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HangWatchdog":
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="hang-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=self.step_timeout)

    def beat(self) -> None:
        """A step completed (or the loop is alive at a boundary)."""
        self._last_beat = time.monotonic()
        self._fired = False
        self._paused = False

    def pause(self) -> None:
        """Suspend detection across non-step phases (eval, shutdown)."""
        self._paused = True

    def _watch(self) -> None:
        poll = max(0.05, min(self.step_timeout / 4.0, 1.0))
        while not self._stopping.wait(poll):
            if self._paused or self._fired:
                continue
            elapsed = time.monotonic() - self._last_beat
            if elapsed <= self.step_timeout:
                continue
            self._fired = True
            self.hangs_detected += 1
            profiler.bump_counter("train.hang")
            # flight-record the incident BEFORE any exit path: a hard
            # os._exit leaves nothing else behind. The watcher thread has
            # no step correlation id of its own — the dump's span tail
            # carries the last step's.
            _flight.dump("hang", extra={"elapsed_s": round(elapsed, 3),
                                        "step_timeout_s": self.step_timeout,
                                        "action": self.action})
            msg = (f"train step exceeded step_timeout={self.step_timeout}s "
                   f"(no heartbeat for {elapsed:.1f}s) — stuck H2D or hung "
                   f"collective?")
            if self.on_hang is not None:
                try:
                    self.on_hang(elapsed)
                except Exception:
                    pass
            if self.action == "exit":
                print(f"[supervisor] {msg}; exiting {EXIT_HANG} for the "
                      f"launcher to restart", flush=True)
                os._exit(EXIT_HANG)
            warnings.warn(msg, RuntimeWarning)


class PreemptionHandler:
    """SIGTERM/preemption-notice handler (installed on the main thread).

    The signal only *requests* a stop: the training loop observes
    :attr:`requested` at the next step boundary, checkpoints within the
    remaining :attr:`deadline`, and raises :class:`TrainingPreempted`.
    Previously-installed handlers are restored on :meth:`uninstall`.
    """

    def __init__(self, grace_seconds: float = 30.0,
                 signals: Tuple[int, ...] = (signal.SIGTERM,)):
        self.grace_seconds = float(grace_seconds)
        self.signals = tuple(signals)
        self.requested = False
        self.deadline: Optional[Deadline] = None
        self._prev: dict = {}

    def install(self) -> "PreemptionHandler":
        try:
            for sig in self.signals:
                self._prev[sig] = signal.signal(sig, self._on_signal)
        except ValueError:
            # signal.signal only works on the main thread; a fit() driven
            # from a worker thread trains without preemption handling
            # rather than crashing before the first step
            self.uninstall()
            warnings.warn(
                "preemption handler unavailable off the main thread; "
                "SIGTERM checkpoint-and-exit is disabled for this run",
                RuntimeWarning)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev.clear()

    def _on_signal(self, signum, frame) -> None:
        # flags only: the handler interrupts the main thread mid-bytecode,
        # so taking any non-reentrant lock here (counters, IO) could
        # deadlock against the very frame it interrupted — accounting
        # happens at the step-boundary check instead
        if not self.requested:   # first notice stamps the grace budget
            self.requested = True
            self.deadline = Deadline(self.grace_seconds)


class TrainingSupervisor:
    """Ties watchdogs, AutoCheckpoint and the preemption handler around a
    training step (``TrainStep`` / ``_HapiTrainStep`` — anything with
    ``watchdog_call``, ``inject_anomaly``, ``state_dict`` /
    ``set_state_dict`` and ``_count``).

    Usage (``Model.fit(recovery=...)`` wraps exactly this)::

        sup = TrainingSupervisor(step, policy).start()
        cursor = sup.restore()            # None on a fresh run
        try:
            for epoch, i, batch in ...:   # resumed/fast-forwarded stream
                if sup.should_skip(epoch, i):
                    continue
                sup.before_batch()        # fault sites; stall/poison seams
                loss, ok, found = step.watchdog_call(batch)
                sup.after_batch(epoch, i, loss, ok, found)
        except RollbackRequested as rb:   # rewind data to rb.cursor
            ...
        except TrainingPreempted:         # checkpointed; exit/resume later
            ...
        finally:
            sup.stop()
    """

    def __init__(self, step, policy: RecoveryPolicy,
                 cursor_fn: Optional[Callable[[], "object"]] = None):
        from ..distributed.checkpoint import AutoCheckpoint

        if policy.integrity_check_interval is not None:
            raise NotImplementedError(
                "RecoveryPolicy(integrity_check_interval=...): the "
                "cross-replica integrity vote needs replicas and is not "
                "ported yet (ROADMAP A8)")
        self.step = step
        self.policy = policy
        self.checkpoint = AutoCheckpoint(
            policy.checkpoint_dir,
            save_interval_steps=max(1, int(policy.save_interval_steps)),
            keep_max=policy.keep_max, async_save=policy.async_save)
        self.watchdog = NumericsWatchdog(policy.check_interval,
                                         policy.max_consecutive)
        self.hang = (HangWatchdog(policy.step_timeout, policy.hang_action)
                     if policy.step_timeout else None)
        self.preempt = (PreemptionHandler(policy.grace_seconds)
                        if policy.preemption else None)
        # cursor_fn supplies the CURRENT input-pipeline position (the NEXT
        # batch) whenever a checkpoint is cut mid-run
        self.cursor_fn = cursor_fn
        self.rollbacks = 0
        self.skipped_batches = 0
        self._skip: Set[Tuple[int, int]] = set()
        # events: the hapi layer routes these into callbacks
        self.on_anomaly: Optional[Callable] = None
        self.on_rollback: Optional[Callable] = None
        self.on_preemption: Optional[Callable] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "TrainingSupervisor":
        if self.preempt is not None:
            self.preempt.install()
        if self.hang is not None:
            self.hang.start()
        return self

    def stop(self) -> None:
        if self.hang is not None:
            self.hang.stop()
        if self.preempt is not None:
            self.preempt.uninstall()
        self.checkpoint.wait()
        # the last step's correlation id (stamped by before_batch) must
        # not leak past the supervised run: a later generate() on this
        # thread would inherit the stale train-step lane
        _tracing.set_current(None)

    def __enter__(self) -> "TrainingSupervisor":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # ------------------------------------------------------ state plumbing
    def _template(self, with_cursor: bool = True) -> dict:
        from ..io.cursor import DataCursor

        t = dict(self.step.state_dict())
        if with_cursor:
            t["data_cursor"] = DataCursor().as_state()
        return t

    def restore(self):
        """Restore the newest VALID checkpoint into the step (crc-verified;
        torn/corrupt candidates are skipped by ``latest_checkpoint``).
        Returns the recorded :class:`DataCursor`, ``None`` when there is no
        checkpoint or it predates cursors (old checkpoints still load; the
        data stream then restarts at epoch 0). A candidate that fails to
        LOAD (corruption surfacing between validation and read) is skipped
        and the next newest complete checkpoint is tried; candidates that
        failed VALIDATION are remembered too, so each retry does not
        re-crc every shard of already-rejected newer checkpoints."""
        from ..distributed.checkpoint import (_STEP_DIR,
                                              CheckpointCorruptError,
                                              _flatten, _unflatten,
                                              latest_checkpoint, load_state)
        from ..io.cursor import DataCursor

        tried = []
        while True:
            path = latest_checkpoint(self.checkpoint.root, exclude=tried,
                                     on_invalid=tried.append)
            if path is None:
                return None
            try:
                # "proactive": every recorded shard is crc-verified up
                # front — supervisor restores must not trust lazy reads
                flat = load_state(path, verify="proactive")
                # only a load that SUCCEEDED counts as a reshard — skipped
                # candidates must not bump the counter or log a resize
                self._report_reshard(path)
                break
            except CheckpointCorruptError as e:
                warnings.warn(
                    f"checkpoint {path} failed to load ({e}); falling back "
                    f"to the next newest complete checkpoint",
                    RuntimeWarning)
                tried.append(path)
        template = self._template(with_cursor=True)
        flat_t, _ = _flatten(template)
        missing = [k for k in flat_t if k not in flat]
        cursor_missing = any(k.startswith("data_cursor/") for k in missing)
        hard_missing = [k for k in missing
                        if not k.startswith(("data_cursor/", "base_seed",
                                             "scaler_state/"))]
        if hard_missing:
            raise KeyError(
                f"checkpoint {path} is missing required state leaves "
                f"{hard_missing[:5]} — was it written by a different model/"
                f"optimizer configuration?")
        state = _unflatten(template, {k: flat.get(k) for k in flat_t})
        cursor_state = state.pop("data_cursor", None)
        state = {k: v for k, v in state.items()
                 if not (v is None or (isinstance(v, dict)
                                       and any(x is None for x in v.values())))}
        self.step.set_state_dict(state)
        step_no = int(_STEP_DIR.match(os.path.basename(path)).group(1))
        print(f"[supervisor] restored {path} (step {step_no})", flush=True)
        if cursor_missing:
            return None
        return DataCursor.from_state(cursor_state)

    def _report_reshard(self, path: str) -> None:
        """Log + count a cross-topology restore (checkpoint mesh != the
        step's live mesh). Purely observational."""
        from ..distributed.checkpoint import mesh_info

        info = mesh_info(path)
        mesh = getattr(self.step, "mesh", None)
        if not info or mesh is None or not info.get("axes"):
            return
        cur = {str(k): int(v) for k, v in dict(mesh.shape).items()}
        if cur != info["axes"]:
            profiler.bump_counter("train.reshard")
            print(f"[supervisor] elastic reshard: checkpoint written on "
                  f"mesh {info['axes']} ({info.get('devices')} devices); "
                  f"restoring onto {cur} ({mesh.size} devices)", flush=True)

    def save_now(self, cursor=None) -> None:
        """Cut a checkpoint at the current step, recording the cursor."""
        if self.hang is not None:
            self.hang.pause()   # a slow (sync) save is not a hung step
        fault_point("train.ckpt")
        state = dict(self.step.state_dict())
        cursor = cursor if cursor is not None else (
            self.cursor_fn() if self.cursor_fn is not None else None)
        if cursor is not None:
            state["data_cursor"] = cursor.as_state()
        # the step's mesh (a DistributedTrainStep's) goes into the metadata,
        # so that a restore onto another mesh reports the reshard
        self.checkpoint.save(int(self.step._count), state,
                             mesh=getattr(self.step, "mesh", None))

    def maybe_save(self, cursor=None) -> bool:
        if not self.checkpoint._due(int(self.step._count)):
            return False
        self.save_now(cursor)
        return True

    # ------------------------------------------------------------ the loop
    def should_skip(self, epoch: int, batch_index: int) -> bool:
        """True for batches inside a post-rollback ``skip_window``."""
        if (epoch, batch_index) in self._skip:
            self._skip.discard((epoch, batch_index))
            self.skipped_batches += 1
            profiler.bump_counter("train.batch_skip")
            return True
        return False

    def before_batch(self) -> None:
        """Fault sites ahead of the dispatch: a ``delay`` rule at
        ``train.step`` stalls (exercising the hang watchdog), a ``crash``
        kills the process, and a ``drop`` at ``train.data`` (or any fault
        at ``train.bitflip``, whose realiser is not ported) poisons the
        upcoming batch through the step's NaN seam.

        Also the training side's correlation-id mint: each step boundary
        stamps the thread's tracing id, so spans and flight-recorder
        dumps (anomaly, rollback, preemption) attribute to the step that
        caused them."""
        _tracing.set_current(
            f"train-{os.getpid():x}-s{int(self.step._count)}")
        fault_point("train.step")
        for site in ("train.bitflip", "train.data"):
            try:
                fault_point(site)
            except InjectedFault:
                self.step.inject_anomaly()

    def after_batch(self, epoch: int, batch_index: int, loss, ok, found,
                    cursor=None) -> None:
        """Observe flags, heartbeat, checkpoint, honor preemption. May
        raise :class:`RollbackRequested` or :class:`TrainingPreempted`."""
        # beat FIRST: the step dispatched, so the hang window now covers
        # only the flush's device drain — where a stuck kernel would
        # genuinely surface — and not step + flush stacked together
        if self.hang is not None:
            self.hang.beat()
        self.watchdog.observe(epoch, batch_index, loss, ok, found)
        if self.watchdog.due:
            self._flush_watchdog()
        if self.maybe_save(cursor) and self.hang is not None:
            # a (possibly synchronous) checkpoint save is not a hung step
            self.hang.beat()
        if self.preempt is not None and self.preempt.requested:
            self._handle_preemption(cursor)

    def finish_epoch(self) -> None:
        """Drain pending flags at an epoch boundary (and pause the hang
        watchdog across eval/checkpoint phases)."""
        if self.hang is not None:
            self.hang.pause()
        self._flush_watchdog()

    def _flush_watchdog(self) -> None:
        with RecordEvent("watchdog_sync"):
            fresh = self.watchdog.flush()
        for epoch, bi, loss in fresh:
            warnings.warn(
                f"numerics watchdog: non-finite step at epoch {epoch} batch "
                f"{bi} (loss={loss}); update was skipped on the device "
                f"({self.watchdog.consecutive} consecutive)", RuntimeWarning)
            _tracing.record_event("train:anomaly", epoch=epoch, batch=bi,
                                  loss=loss)
            _flight.note("train_anomaly", corr=_tracing.current(),
                         epoch=epoch, batch=bi, loss=loss)
            if self.on_anomaly is not None:
                self.on_anomaly({"epoch": epoch, "batch_index": bi,
                                 "loss": loss})
        if self.watchdog.should_rollback:
            self._rollback()

    def _rollback(self) -> None:
        if self.hang is not None:
            # restore from slow storage is not a hung step; the next
            # post-rollback beat() re-arms detection
            self.hang.pause()
        self.rollbacks += 1
        profiler.bump_counter("train.rollback")
        # crash artifact while the ring still holds the anomaly lead-up
        # (the restore below rewinds state; the telemetry must not rewind)
        _tracing.record_event("train:rollback", rollbacks=self.rollbacks)
        _flight.dump("rollback", corr=_tracing.current(),
                     extra={"rollbacks": self.rollbacks,
                            "first_bad": list(self.watchdog.first_bad)
                            if self.watchdog.first_bad else None,
                            "anomalies": self.watchdog.anomalies})
        if self.rollbacks > self.policy.max_rollbacks:
            raise FloatingPointError(
                f"numerics watchdog: {self.rollbacks} rollbacks exceeded "
                f"max_rollbacks={self.policy.max_rollbacks}; training is "
                f"not recovering (check data/lr)")
        first_bad = self.watchdog.first_bad
        skip: Set[Tuple[int, int]] = set()
        if first_bad is not None and self.policy.skip_window > 0:
            e0, b0 = first_bad
            skip = {(e0, b0 + j) for j in range(self.policy.skip_window)}
        with RecordEvent("rollback"):
            self.checkpoint.wait()   # an in-flight async save must land first
            cursor = self.restore()
        self.watchdog.consecutive = 0
        self.watchdog.first_bad = None
        self._skip |= skip
        print(f"[supervisor] rollback #{self.rollbacks}: replaying from "
              f"{'checkpoint' if cursor is not None else 'current position'}"
              f"{f', skipping {len(skip)} batch(es)' if skip else ''}",
              flush=True)
        if self.on_rollback is not None:
            self.on_rollback({"rollbacks": self.rollbacks,
                              "cursor": cursor, "skip": sorted(skip)})
        raise RollbackRequested(cursor, skip)

    def _handle_preemption(self, cursor=None) -> None:
        profiler.bump_counter("train.preemption")
        _flight.dump("preemption", corr=_tracing.current(),
                     extra={"global_step": int(self.step._count)})
        if self.hang is not None:
            self.hang.pause()
        saved = False
        deadline = self.preempt.deadline
        if deadline is None or not deadline.expired():
            with RecordEvent("preempt_ckpt"):
                self.save_now(cursor)
                self.checkpoint.wait()
            saved = True
        if self.on_preemption is not None:
            self.on_preemption({"global_step": int(self.step._count),
                                "saved": saved})
        detail = ("state checkpointed" if saved
                  else "grace deadline expired, state NOT saved")
        raise TrainingPreempted(
            f"preemption notice honored at step {self.step._count} "
            f"({detail})", int(self.step._count), saved)
