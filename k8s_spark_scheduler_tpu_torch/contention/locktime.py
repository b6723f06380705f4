"""Always-on lock wait/hold telemetry — the timing half of the
contention observatory; a copy of the reference package's
``contention/locktime.py``.

``TimedLock`` wraps a raw ``threading.Lock``/``RLock`` and measures,
per lock:

- **wait time** — how long ``acquire`` blocked (sampled reservoir,
  contended acquires always recorded);
- **hold time** — how long the lock was held, attributed to the
  *phase* that held it (the active span name, read from this package's
  tracing ``ContextVar``, ``tracing/spans.py``);
- **top blockers** — who I waited on, for how long: the holder's
  phase is snapshotted just before blocking, so every contended wait
  is charged to the phase that caused it.

Wrapping layers compose with the race detector: ``@guarded_by``
wraps the raw lock in a ``TimedLock`` first, and — only when
``SCHEDLINT_RACECHECK`` is active — racecheck then wraps the
``TimedLock`` in its ``TrackedLock`` proxy, so the timing layer sits
innermost and times the real lock, not the detector.

Why this is cheap and safe:

- every statistics mutation happens **while the measured lock is
  held** (wait is recorded just after acquiring, hold just before
  releasing), so the lock serializes its own bookkeeping — no extra
  lock on the hot path, ever;
- a waiter reads the current holder's attribution tuple *without*
  the lock — a benign racy read of an immutable tuple that can at
  worst misattribute one wait to an adjacent holder;
- uncontended acquires are *sampled* (1 in ``sample_every``); the
  contended path — where the signal lives — always records;
- the disabled path costs one module-attribute read plus the
  delegation call, mirroring ``racecheck.note_access``.

Module switchboard (mirrors ``analysis.racecheck``): ``enable()``
installs the process-wide :class:`LockTimekeeper`; ``active()`` /
``get()`` read it; ``disable()`` removes it.  TimedLocks exist either
way — they just stop recording when no keeper is installed.
"""

from __future__ import annotations

import random
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

_keeper: Optional["LockTimekeeper"] = None

# every TimedLock in the process, for snapshot()/publish() enumeration
# (weak: a dropped lock must not leak its stats forever)
_registry_lock = threading.Lock()
_locks: "weakref.WeakSet[TimedLock]" = weakref.WeakSet()

_LOCK_TYPE = type(threading.Lock())

RESERVOIR_CAP = 256
BLOCKER_TABLE_CAP = 32
PHASE_TABLE_CAP = 64
PENDING_CAP = 512
DEFAULT_SAMPLE_EVERY = 64
# stride used for locks wrapped via @guarded_by; wiring sets it from
# ContentionConfig before the server's guarded singletons construct
_default_sample_every = DEFAULT_SAMPLE_EVERY


def set_default_sample_every(stride: int) -> None:
    global _default_sample_every
    _default_sample_every = max(1, int(stride))


def active() -> bool:
    return _keeper is not None


def get() -> Optional["LockTimekeeper"]:
    return _keeper


def enable(keeper: Optional["LockTimekeeper"] = None) -> "LockTimekeeper":
    """Install (idempotently) the process-wide timekeeper and return
    it.  Safe to call from every server wiring in a test process —
    the first call wins unless an explicit keeper is passed."""
    global _keeper
    if keeper is not None:
        _keeper = keeper
    elif _keeper is None:
        _keeper = LockTimekeeper()
    return _keeper


def disable() -> None:
    global _keeper
    _keeper = None


# phase attribution: the active span's name.  Lazy import breaks the
# contention → tracing → guarded → contention cycle; cached so the hot
# path pays one global read, not a sys.modules lookup.
_current_span = None


def _phase() -> str:
    global _current_span
    cs = _current_span
    if cs is None:
        from ..tracing.spans import current_span as cs

        _current_span = cs
    span = cs()
    name = getattr(span, "name", None)
    return name if name is not None else ""


class _Reservoir:
    """Algorithm-R sampled reservoir + exact count/total/max.  Own RNG
    seeded from the lock name: deterministic per lock, no global
    random state touched on the hot path."""

    __slots__ = ("cap", "values", "count", "total", "max", "_rng")

    def __init__(self, cap: int, seed: int):
        self.cap = cap
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._rng = random.Random(seed)

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v
        if len(self.values) < self.cap:
            self.values.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self.values[j] = v

    def snapshot_ms(self) -> Dict[str, Any]:
        vals = sorted(self.values)

        def pct(q: float) -> float:
            if not vals:
                return 0.0
            return vals[min(len(vals) - 1, int(q * len(vals)))] * 1000.0

        return {
            "count": self.count,
            "mean": round(self.total / self.count * 1000.0, 4) if self.count else 0.0,
            "p50": round(pct(0.50), 4),
            "p95": round(pct(0.95), 4),
            "p99": round(pct(0.99), 4),
            "max": round(self.max * 1000.0, 4),
        }


class TimedLock:
    """Lock proxy with wait/hold timing.  Exposes the full protocol
    racecheck's ``TrackedLock`` needs from an inner lock —
    ``acquire(blocking, timeout)``, ``release()``, ``locked()``,
    context manager — so the two proxies stack cleanly."""

    __slots__ = (
        "name",
        "sample_every",
        "tag_waits",
        "_inner",
        "_reentrant",
        "_tl",
        "_wait",
        "_hold",
        "_acquisitions",
        "_contended",
        "_holder",
        "_hold_t0",
        "_hold_phase",
        "_by_phase",
        "_blockers",
        "_pending_wait",
        "_pending_hold",
        "__weakref__",
    )

    def __init__(
        self,
        inner,
        name: str,
        sample_every: int = DEFAULT_SAMPLE_EVERY,
        tag_waits: bool = False,
    ):
        self._inner = inner
        self.name = name
        self.sample_every = max(1, sample_every)
        # annotate the active span with accumulated lockWaitMs — only
        # for request-path locks (the extender predicate lock), so the
        # critical-path extractor can carve the wait out of the request
        self.tag_waits = tag_waits
        self._reentrant = not isinstance(inner, _LOCK_TYPE)
        self._tl = threading.local() if self._reentrant else None
        seed = hash(name) & 0xFFFF ^ 0x5EED
        self._wait = _Reservoir(RESERVOIR_CAP, seed)
        self._hold = _Reservoir(RESERVOIR_CAP, seed ^ 0xA5A5)
        self._acquisitions = 0
        self._contended = 0
        # (phase, thread name) of the current holder — written only by
        # the holder, read racily by waiters for blame attribution
        self._holder: Optional[Tuple[str, str]] = None
        self._hold_t0: Optional[float] = None
        self._hold_phase = ""
        self._by_phase: Dict[str, List[float]] = {}  # phase -> [holds, total_s, max_s]
        self._blockers: Dict[str, List[float]] = {}  # phase -> [waits, total_s]
        # bounded recent-sample buffers, drained by publish() into the
        # metrics registry as real histogram points
        self._pending_wait: List[float] = []
        self._pending_hold: List[Tuple[str, float]] = []
        with _registry_lock:
            _locks.add(self)

    # -- lock protocol ---------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _keeper is None:
            got = self._inner.acquire(blocking, timeout)
            if got and self._reentrant:
                # depth stays tracked even while disabled: locked() needs
                # it (a same-thread RLock probe succeeds reentrantly, so
                # probing can never detect our own hold), and a keeper
                # enabled mid-hold must still see consistent depths
                tl = self._tl
                tl.depth = getattr(tl, "depth", 0) + 1
            return got
        return self._timed_acquire(blocking, timeout)

    def release(self) -> None:
        if _keeper is None:
            if self._reentrant:
                tl = self._tl
                depth = getattr(tl, "depth", 0)
                if depth:
                    tl.depth = depth - 1
            self._holder = None
            self._hold_t0 = None
            self._inner.release()
            return
        self._timed_release()

    def locked(self) -> bool:
        fn = getattr(self._inner, "locked", None)
        if fn is not None:
            return fn()
        # RLock grows .locked() only in Python 3.14; approximate: held
        # by this thread (probing would succeed reentrantly and lie),
        # else a net-zero non-blocking probe
        if self._reentrant and getattr(self._tl, "depth", 0) > 0:
            return True
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<TimedLock {self.name!r} wrapping {self._inner!r}>"

    # -- timed paths -----------------------------------------------------------

    def _timed_acquire(self, blocking: bool, timeout: float) -> bool:
        inner = self._inner
        got = inner.acquire(False)
        wait_s = 0.0
        blocker: Optional[Tuple[str, str]] = None
        if not got:
            if not blocking:
                # failed probe: no lock held, so no stats (they would
                # race); probes are rare and carry no latency signal
                return False
            # blame whoever holds it right now (benign racy read)
            blocker = self._holder
            t0 = time.perf_counter()
            got = inner.acquire(True, timeout)
            wait_s = time.perf_counter() - t0
            if not got:
                return False
        if self._reentrant:
            tl = self._tl
            depth = getattr(tl, "depth", 0)
            tl.depth = depth + 1
            if depth:
                return True  # only the outermost acquire/release is timed
        # -- we hold the lock: everything below is serialized by it --
        self._acquisitions += 1
        contended = blocker is not None or wait_s > 0.0
        sampled = contended or (self._acquisitions % self.sample_every == 0)
        if contended:
            self._contended += 1
            self._wait.add(wait_s)
            phase = blocker[0] if blocker and blocker[0] else "unknown"
            slot = self._blockers.get(phase)
            if slot is not None:
                slot[0] += 1
                slot[1] += wait_s
            elif len(self._blockers) < BLOCKER_TABLE_CAP:
                self._blockers[phase] = [1, wait_s]
            if len(self._pending_wait) < PENDING_CAP:
                self._pending_wait.append(wait_s)
        elif sampled:
            self._wait.add(0.0)
        # holder attribution is written on EVERY timed acquire (cheap:
        # one ContextVar read) so a waiter can always blame someone;
        # the perf_counter + reservoir work stays sampled
        my_phase = _phase()
        self._holder = (my_phase, threading.current_thread().name)
        if sampled:
            self._hold_phase = my_phase
            self._hold_t0 = time.perf_counter()
        else:
            self._hold_t0 = None
        if self.tag_waits:
            self._tag_active_span(wait_s)
        return True

    def _timed_release(self) -> None:
        if self._reentrant:
            tl = self._tl
            depth = getattr(tl, "depth", 0)
            if depth > 1:
                tl.depth = depth - 1
                self._inner.release()
                return
            if depth:
                tl.depth = 0
        t0 = self._hold_t0
        if t0 is not None:
            hold_s = time.perf_counter() - t0
            phase = self._hold_phase
            self._hold.add(hold_s)
            slot = self._by_phase.get(phase)
            if slot is not None:
                slot[0] += 1
                slot[1] += hold_s
                if hold_s > slot[2]:
                    slot[2] = hold_s
            elif len(self._by_phase) < PHASE_TABLE_CAP:
                self._by_phase[phase] = [1, hold_s, hold_s]
            if len(self._pending_hold) < PENDING_CAP:
                self._pending_hold.append((phase, hold_s))
        self._holder = None
        self._hold_t0 = None
        self._inner.release()

    def _tag_active_span(self, wait_s: float) -> None:
        global _current_span
        cs = _current_span
        if cs is None:
            from ..tracing.spans import current_span as cs

            _current_span = cs
        span = cs()
        tags = getattr(span, "tags", None)
        if span is not None and tags is not None:
            tags["lockWaitMs"] = round(
                tags.get("lockWaitMs", 0.0) + wait_s * 1000.0, 4
            )

    # -- introspection ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Racy-but-consistent-enough view for /debug/contention."""
        blockers = sorted(
            (
                {
                    "holderPhase": phase,
                    "waits": int(slot[0]),
                    "totalWaitMs": round(slot[1] * 1000.0, 4),
                }
                for phase, slot in list(self._blockers.items())
            ),
            key=lambda b: -b["totalWaitMs"],
        )
        by_phase = {
            phase: {
                "holds": int(slot[0]),
                "totalMs": round(slot[1] * 1000.0, 4),
                "maxMs": round(slot[2] * 1000.0, 4),
            }
            for phase, slot in sorted(self._by_phase.items())
        }
        return {
            "name": self.name,
            "acquisitions": self._acquisitions,
            "contended": self._contended,
            "sampleEvery": self.sample_every,
            "waitMs": self._wait.snapshot_ms(),
            "holdMs": self._hold.snapshot_ms(),
            "byPhase": by_phase,
            "topBlockers": blockers,
        }


class LockTimekeeper:
    """Process-wide handle over every TimedLock: snapshot aggregation
    for ``/debug/contention`` and metric publication for ``/metrics``.
    Holds no per-lock state — each lock carries its own, serialized by
    itself (see module docstring)."""

    def snapshot(self, name_filter: Optional[str] = None) -> List[Dict[str, Any]]:
        """Per-lock-name aggregate stats, busiest first.  Many
        instances of one guarded class share a name; their snapshots
        merge so the table stays O(#lock sites), not O(#instances)."""
        with _registry_lock:
            locks = list(_locks)
        merged: Dict[str, Dict[str, Any]] = {}
        for lk in locks:
            if name_filter is not None and lk.name != name_filter:
                continue
            snap = lk.snapshot()
            agg = merged.get(lk.name)
            if agg is None:
                snap["instances"] = 1
                merged[lk.name] = snap
            else:
                agg["instances"] += 1
                agg["acquisitions"] += snap["acquisitions"]
                agg["contended"] += snap["contended"]
                _merge_dist(agg["waitMs"], snap["waitMs"])
                _merge_dist(agg["holdMs"], snap["holdMs"])
                _merge_phase(agg["byPhase"], snap["byPhase"])
                agg["topBlockers"] = _merge_blockers(
                    agg["topBlockers"], snap["topBlockers"]
                )
        return sorted(
            merged.values(), key=lambda s: (-s["contended"], -s["acquisitions"])
        )

    def publish(self, metrics) -> None:
        """Drain each lock's pending samples into the metrics registry
        as real histogram points, plus cumulative-count gauges.  Called
        from the reporter tick and on /debug/contention reads — never
        from the lock hot path (the registry's own lock is timed too;
        recording from inside acquire/release would recurse)."""
        from ..metrics import names as M

        with _registry_lock:
            locks = list(_locks)
        for lk in locks:
            if not lk._acquisitions:
                continue
            tags = {M.TAG_LOCK: lk.name}
            pending_wait, lk._pending_wait = lk._pending_wait, []
            pending_hold, lk._pending_hold = lk._pending_hold, []
            for wait_s in pending_wait:
                metrics.histogram(M.LOCK_WAIT_TIME, wait_s, tags)
            for phase, hold_s in pending_hold:
                metrics.histogram(
                    M.LOCK_HOLD_TIME,
                    hold_s,
                    {M.TAG_LOCK: lk.name, M.TAG_PHASE: phase or "-"},
                )
            metrics.gauge(M.LOCK_ACQUIRE_COUNT, float(lk._acquisitions), tags)
            metrics.gauge(M.LOCK_CONTENDED_COUNT, float(lk._contended), tags)
            for phase, slot in list(lk._blockers.items()):
                metrics.gauge(
                    M.LOCK_BLOCKED_SECONDS,
                    round(slot[1], 6),
                    {M.TAG_LOCK: lk.name, M.TAG_HOLDER: phase},
                )


def _merge_dist(agg: Dict[str, Any], other: Dict[str, Any]) -> None:
    total = agg["count"] + other["count"]
    if total:
        agg["mean"] = round(
            (agg["mean"] * agg["count"] + other["mean"] * other["count"]) / total, 4
        )
    # percentiles across instances: keep the worst observed (the
    # conservative read for a contention table)
    for key in ("p50", "p95", "p99", "max"):
        agg[key] = max(agg[key], other[key])
    agg["count"] = total


def _merge_phase(agg: Dict[str, Any], other: Dict[str, Any]) -> None:
    for phase, stats in other.items():
        slot = agg.get(phase)
        if slot is None:
            if len(agg) < PHASE_TABLE_CAP:
                agg[phase] = dict(stats)
        else:
            slot["holds"] += stats["holds"]
            slot["totalMs"] = round(slot["totalMs"] + stats["totalMs"], 4)
            slot["maxMs"] = max(slot["maxMs"], stats["maxMs"])


def _merge_blockers(agg: List[Dict], other: List[Dict]) -> List[Dict]:
    by_phase: Dict[str, Dict] = {b["holderPhase"]: dict(b) for b in agg}
    for b in other:
        slot = by_phase.get(b["holderPhase"])
        if slot is None:
            if len(by_phase) < BLOCKER_TABLE_CAP:
                by_phase[b["holderPhase"]] = dict(b)
        else:
            slot["waits"] += b["waits"]
            slot["totalWaitMs"] = round(slot["totalWaitMs"] + b["totalWaitMs"], 4)
    return sorted(by_phase.values(), key=lambda b: -b["totalWaitMs"])


def wrap_instance(obj: Any, cls: type, lock_attr: str) -> None:
    """Swap a freshly constructed ``@guarded_by`` instance's raw lock
    for a TimedLock named after the declaration site.  Idempotent;
    runs unconditionally from the guarded ``__init__`` wrapper —
    that is what "always-on" means (recording still gates on the
    keeper switchboard)."""
    inner = getattr(obj, lock_attr, None)
    if inner is None or isinstance(inner, TimedLock):
        return
    # never time the race detector's proxy: timing wraps the raw lock
    from ..analysis import racecheck

    if isinstance(inner, racecheck.TrackedLock):
        return
    if not hasattr(inner, "acquire") or not hasattr(inner, "release"):
        return
    object.__setattr__(
        obj,
        lock_attr,
        TimedLock(
            inner,
            f"{cls.__name__}.{lock_attr}",
            sample_every=_default_sample_every,
        ),
    )


def snapshot(name_filter: Optional[str] = None) -> List[Dict[str, Any]]:
    keeper = _keeper
    return keeper.snapshot(name_filter) if keeper is not None else []


def publish(metrics) -> None:
    keeper = _keeper
    if keeper is not None:
        keeper.publish(metrics)
