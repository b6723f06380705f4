"""Runtime race detection: Eraser lockset + FastTrack-style vector
clocks + a lock-order recorder, over the ``@guarded_by`` registry; a
copy of the reference package's ``analysis/racecheck.py``.

Static lock-discipline rules (LK*) catch mutations that are *lexically*
outside the declared ``with lock:`` scope; this module catches what the
AST cannot: a mutation reached on a path where the lock genuinely is
not held, accesses on two threads with no *ordering* between them, and
lock acquisition orders that could deadlock.

Two detectors run over the same instrumentation checkpoints:

- **Lockset** (Savage et al., "Eraser", SOSP '97): every
  :func:`guarded_by <.guarded.guarded_by>`-decorated class built while
  the detector is active gets its lock attribute wrapped in a
  :class:`TrackedLock` proxy that maintains a per-thread held-lock set;
  mutation sites call :func:`note_access`, which intersects the
  candidate lockset for ``(instance, field)`` with the locks currently
  held.  A field written by two or more threads with an empty candidate
  lockset is reported (state machine: virgin → exclusive(first thread)
  → shared → shared-modified, exactly Eraser's refinement so
  single-threaded init and read-sharing don't false-positive).
- **Happens-before** (Flanagan & Freund, "FastTrack", PLDI '09 —
  adapted to full vector clocks, which are cheap at checkpoint
  granularity): each thread carries a vector clock; release/acquire on
  any :class:`TrackedLock` creates an edge, as do thread start/join
  (hooked on ``threading.Thread``) and the explicit channel edges
  (:func:`hb_publish` / :func:`hb_observe`) that cover synchronization
  the lockset cannot express — ``ChangeFeed`` publish → sampler wakeup,
  ``IntentJournal`` persist → replay, the write-back queue handoff.
  Two accesses to the same field, at least one a write, on different
  threads with neither ordered before the other is a **data race**, and
  the report carries *both* access sites.  The two detectors disagree in
  exactly the documented directions: a channel-synchronized handoff is
  lockset noise but HB-clean; an unsynchronized write→read pair is
  lockset-silent (Eraser only reports on shared-*modified*) but an HB
  race.

The acquisition-order graph: acquiring lock B while holding lock A
adds edge A→B; a pre-existing path B⇝A means a lock-order cycle
(potential deadlock), recorded with both lock names.

Enablement: ``SCHEDLINT_RACECHECK=1`` in the environment makes the test
harness call :func:`enable` before any guarded instance is constructed;
tests may also call :func:`enable` / :func:`disable` directly.  When
inactive, :func:`note_access` is a single module-attribute read and a
``None`` check — cheap enough to leave in the hot paths permanently.

Instances constructed *before* the detector was enabled carry untracked
raw locks; their accesses are skipped (``_schedlint_tracked`` marker)
rather than misreported as lock-free.

The model checker (:mod:`.modelcheck`) reuses this instrumentation as
its preemption points: a cooperative scheduler hook installed via
:func:`set_sched_hook` is consulted at every tracked acquire/release
and every :func:`note_access` checkpoint, which is how small scenarios
get systematically interleaved without touching the code under test.

The detector is process-wide (module state), and so are the
``threading.Thread`` start/join hooks it installs.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Optional, Set, Tuple

ENV_FLAG = "SCHEDLINT_RACECHECK"

# Eraser field states
_VIRGIN = 0
_EXCLUSIVE = 1
_SHARED = 2
_SHARED_MODIFIED = 3


def enabled_via_env() -> bool:
    return os.environ.get(ENV_FLAG, "") not in ("", "0", "false")


@dataclass
class RaceReport:
    owner: str           # ClassName#n
    field: str
    threads: Tuple[str, ...]
    note: str

    def __str__(self) -> str:
        return (
            f"unprotected shared write: {self.owner}.{self.field} "
            f"written by {', '.join(self.threads)} with empty lockset ({self.note})"
        )


# (filename, lineno, function) of an instrumented access — the frame
# that called note_access, i.e. the mutation site itself
Site = Tuple[str, int, str]


def _fmt_site(site: Optional[Site]) -> str:
    if site is None:
        return "<unknown>"
    fn, line, func = site
    return f"{os.path.basename(fn)}:{line} in {func}"


@dataclass
class HbRaceReport:
    """A happens-before data race: two accesses to the same field, at
    least one a write, with no ordering edge between them.  Both access
    sites are carried so the report is actionable without a debugger."""

    owner: str
    field: str
    first_thread: str
    first_site: Optional[Site]
    first_write: bool
    second_thread: str
    second_site: Optional[Site]
    second_write: bool

    def __str__(self) -> str:
        def rw(w: bool) -> str:
            return "write" if w else "read"

        return (
            f"happens-before race: {self.owner}.{self.field} — "
            f"{rw(self.first_write)} by {self.first_thread} at "
            f"{_fmt_site(self.first_site)} unordered with "
            f"{rw(self.second_write)} by {self.second_thread} at "
            f"{_fmt_site(self.second_site)}"
        )


@dataclass
class LockOrderReport:
    edge: Tuple[str, str]      # the acquisition that closed the cycle
    cycle: Tuple[str, ...]     # lock names along the pre-existing path

    def __str__(self) -> str:
        a, b = self.edge
        return (
            f"lock-order cycle: acquiring {b} while holding {a}, but "
            f"{' -> '.join(self.cycle)} already recorded"
        )


class TrackedLock:
    """Proxy over a real ``Lock``/``RLock`` that maintains the calling
    thread's held-lock set, the global acquisition-order graph, and the
    release/acquire vector-clock edges.  Reentrant acquisitions (RLock)
    are counted so the held set stays accurate."""

    def __init__(self, inner, name: str, detector: "RaceDetector"):
        self._inner = inner
        self.name = name
        self._detector = detector
        self._counts = threading.local()

    # -- lock protocol --------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        hook = _sched_hook
        if hook is not None and hook.controls_current_thread():
            # cooperative mode: a preemption point, then spin-yield until
            # the non-blocking acquire succeeds (only one thread runs at
            # a time, so a real blocking acquire would deadlock the run)
            hook.preempt(f"acquire:{self.name}")
            while not self._inner.acquire(False):
                if not blocking:
                    return False
                hook.wait_for_lock(self)
            self._on_acquired()
            if self._depth() == 1:
                hook.lock_acquired(self)
            return True
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._on_acquired()
        return got

    def release(self) -> None:
        fully = self._on_release()
        self._inner.release()
        if fully:
            hook = _sched_hook
            if hook is not None and hook.controls_current_thread():
                hook.lock_released(self)
                hook.preempt(f"release:{self.name}")

    def __enter__(self):
        self.acquire()  # schedlint: disable=LK002 -- lock proxy: __exit__ is the paired release
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def locked(self) -> bool:
        inner_locked = getattr(self._inner, "locked", None)
        if inner_locked is not None:
            return inner_locked()
        # RLock grows .locked() only in Python 3.14; approximate: held by
        # this thread, else a non-blocking probe (net-zero, untracked)
        if self._depth() > 0:
            return True
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    # -- tracking -------------------------------------------------------------

    def _depth(self) -> int:
        return getattr(self._counts, "n", 0)

    def _on_acquired(self) -> None:
        n = self._depth()
        self._counts.n = n + 1
        if n == 0:  # outermost acquisition only
            self._detector._lock_acquired(self)

    def _on_release(self) -> bool:
        """True when this release drops the outermost hold."""
        n = self._depth()
        if n <= 1:
            self._counts.n = 0
            self._detector._lock_released(self)
            return True
        self._counts.n = n - 1
        return False


@dataclass
class _FieldState:
    state: int = _VIRGIN
    first_thread: Optional[int] = None
    lockset: Optional[FrozenSet[str]] = None   # None = universe (virgin)
    threads: Set[str] = field(default_factory=set)
    reported: bool = False


@dataclass
class _HbFieldState:
    """Per-field happens-before access history: the last write and the
    last read per thread token, each with its epoch and source site."""

    writes: Dict[int, Tuple[int, Optional[Site], str]] = field(default_factory=dict)
    reads: Dict[int, Tuple[int, Optional[Site], str]] = field(default_factory=dict)
    reported: bool = False


class _ThreadState:
    """Per-thread detector state (token, vector clock, held stack)."""

    __slots__ = ("token", "vc", "stack")

    def __init__(self, token: int):
        self.token = token
        self.vc: Dict[int, int] = {token: 1}
        self.stack: List[TrackedLock] = []


def _vc_join(dst: Dict[int, int], src: Dict[int, int]) -> None:
    for tok, epoch in src.items():
        if epoch > dst.get(tok, 0):
            dst[tok] = epoch


class RaceDetector:  # schedlint: disable=LK004 -- the detector cannot instrument itself: _mu guards its own bookkeeping
    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()           # .state → _ThreadState
        self._thread_seq = 0
        self._instances: Dict[int, str] = {}    # id(owner) → display name
        self._by_class_seq: Dict[str, int] = {}
        self._fields: Dict[Tuple[int, str], _FieldState] = {}
        self._hb_fields: Dict[Tuple[int, str], _HbFieldState] = {}
        self._edges: Dict[str, Set[str]] = {}   # lock name → successors
        # vector-clock state shared across threads (all under _mu).
        # _vc_by_token grows one small dict per thread that TOUCHED the
        # detector (threads that never do create no entry); lock VCs are
        # keyed WEAKLY by the TrackedLock itself so a churned guarded
        # instance's freed lock cannot hand its clock to an unrelated
        # new lock via id reuse (same rationale as the fork bookkeeping)
        self._vc_by_token: Dict[int, Dict[int, int]] = {}
        self._lock_vcs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._channel_vcs: Dict[object, Dict[int, int]] = {}
        # fork/join bookkeeping is keyed WEAKLY by the Thread object:
        # a started-but-never-joined thread that never touches the
        # detector (one per HTTP connection under ThreadingHTTPServer)
        # must not pin a vector-clock copy forever, and id()-keying
        # would let a recycled id hand a dead thread's parent clock to
        # an unrelated new thread, fabricating ordering edges
        self._fork_vcs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._token_by_thread: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self.races: List[RaceReport] = []
        self.hb_races: List[HbRaceReport] = []
        self.lock_order_violations: List[LockOrderReport] = []
        _install_thread_hooks()

    # -- per-thread state -----------------------------------------------------

    def _thread_state(self) -> _ThreadState:
        """The calling thread's state; created on first use.  Tokens are
        unique and never recycled (OS thread idents from
        ``threading.get_ident()`` ARE recycled once a thread exits — a
        fast first writer's ident can be reused by the second, making a
        two-thread race look single-threaded).  Creation consumes any
        pending fork edge recorded by the ``Thread.start`` hook, so a
        child's first access is ordered after everything its parent did
        before starting it."""
        st = getattr(self._tls, "state", None)
        if st is None:
            cur = threading.current_thread()
            with self._mu:
                self._thread_seq += 1
                st = _ThreadState(self._thread_seq)
                parent_vc = self._fork_vcs.pop(cur, None)
                if parent_vc is not None:
                    _vc_join(st.vc, parent_vc)
                self._vc_by_token[st.token] = st.vc
                self._token_by_thread[cur] = st.token
            self._tls.state = st
        return st

    def _held_stack(self) -> List[TrackedLock]:
        return self._thread_state().stack

    def held_lock_names(self) -> FrozenSet[str]:
        return frozenset(lk.name for lk in self._held_stack())

    def _thread_token(self) -> int:
        return self._thread_state().token

    # -- thread start/join edges ----------------------------------------------

    def _on_thread_start(self, thread: threading.Thread) -> None:
        st = self._thread_state()
        with self._mu:
            # child inherits everything the parent has done so far …
            self._fork_vcs[thread] = dict(st.vc)
            # … and the parent's subsequent work is NOT ordered before it
            st.vc[st.token] += 1

    def _on_thread_join(self, thread: threading.Thread) -> None:
        st = self._thread_state()
        with self._mu:
            token = self._token_by_thread.get(thread)
            if token is not None:
                child_vc = self._vc_by_token.get(token)
                if child_vc is not None:
                    _vc_join(st.vc, child_vc)
            # joining a thread that never touched the detector: no edge
            # needed — it has no recorded accesses to order against
            self._fork_vcs.pop(thread, None)

    # -- lock bookkeeping -----------------------------------------------------

    def _quarantined(self) -> bool:
        """True while the calling thread's detector bookkeeping is
        suspended.  The model checker quarantines its ORCHESTRATOR
        thread around scenario invariant/final calls: those may take
        component locks, and without the quarantine the orchestrator's
        cumulative clock would flow through every lock it touches,
        fabricating happens-before edges BETWEEN scenario threads (and
        acquisition-graph edges the scenario never forms) that mask the
        very races the run exists to find."""
        return getattr(self._tls, "quarantined", False)

    def quarantine_current_thread(self, flag: bool) -> None:
        self._tls.quarantined = flag

    def _lock_acquired(self, lock: TrackedLock) -> None:
        st = self._thread_state()
        if st.stack and not self._quarantined():
            self._record_edge(st.stack[-1].name, lock.name)
        st.stack.append(lock)
        with self._mu:
            if self._quarantined():
                return
            lock_vc = self._lock_vcs.get(lock)
            if lock_vc is not None:
                _vc_join(st.vc, lock_vc)

    def _lock_released(self, lock: TrackedLock) -> None:
        st = self._thread_state()
        # locks are almost always released LIFO; tolerate out-of-order
        for i in range(len(st.stack) - 1, -1, -1):
            if st.stack[i] is lock:
                del st.stack[i]
                break
        with self._mu:
            if self._quarantined():
                return
            lock_vc = self._lock_vcs.setdefault(lock, {})
            _vc_join(lock_vc, st.vc)
            st.vc[st.token] += 1

    def _record_edge(self, held: str, acquiring: str) -> None:
        if held == acquiring:
            return
        with self._mu:
            succs = self._edges.setdefault(held, set())
            if acquiring in succs:
                return
            # does a path acquiring ⇝ held already exist?  Then this
            # acquisition closes a cycle.
            path = self._find_path(acquiring, held)
            succs.add(acquiring)
            if path is not None:
                self.lock_order_violations.append(
                    LockOrderReport(edge=(held, acquiring), cycle=tuple(path))
                )

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        # iterative DFS over the (small) acquisition graph; caller holds _mu
        seen = {src}
        stack = [(src, [src])]
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- explicit happens-before channels -------------------------------------

    def channel_publish(self, channel) -> None:
        """Order everything this thread has done so far before any
        subsequent :meth:`channel_observe` of the same channel."""
        if self._quarantined():
            return
        st = self._thread_state()
        with self._mu:
            ch = self._channel_vcs.setdefault(channel, {})
            _vc_join(ch, st.vc)
            st.vc[st.token] += 1

    def channel_observe(self, channel) -> None:
        """Join every prior publish of ``channel`` into this thread."""
        if self._quarantined():
            return
        st = self._thread_state()
        with self._mu:
            ch = self._channel_vcs.get(channel)
            if ch is not None:
                _vc_join(st.vc, ch)

    def channel_snapshot(self) -> Tuple["RaceDetector", Dict[int, int]]:
        """Capture the calling thread's clock as a detector-tagged
        snapshot.  Carried inside a handed-off item (a queue closure)
        and joined by the consumer via :meth:`join_snapshot`, the edge
        exists exactly iff the handoff happened — a failed non-blocking
        put simply drops the snapshot, so it can never order (and
        thereby hide) a genuinely racing access pair, and a successful
        one is visible to the consumer the instant the item is."""
        st = self._thread_state()
        with self._mu:
            snap = dict(st.vc)
            st.vc[st.token] += 1
        return (self, snap)

    def join_snapshot(self, snapshot: Tuple["RaceDetector", Dict[int, int]]) -> None:
        origin, snap = snapshot
        if origin is not self:
            # produced under a different detector: its tokens are
            # meaningless (and may collide) here — no edge
            return
        st = self._thread_state()
        with self._mu:
            _vc_join(st.vc, snap)

    # -- instance registration ------------------------------------------------

    def track_extra_lock(self, owner: object, lock_attr: str) -> None:
        """Wrap an auxiliary lock attribute (one beyond the class's
        ``@guarded_by`` declaration, e.g. a sample mutex) in a
        TrackedLock so it participates in HB edges, the lock-order
        graph, and — critically — the model checker's cooperative
        scheduling.  Used by model-check scenarios; production code
        never needs it."""
        inner = getattr(owner, lock_attr, None)
        if inner is None or isinstance(inner, TrackedLock):
            return
        name = f"{type(owner).__name__}.{lock_attr}"
        object.__setattr__(owner, lock_attr, TrackedLock(inner, name, self))

    def register_instance(self, owner: object, cls: type, lock_attr: str) -> None:
        """Wrap ``owner.<lock_attr>`` in a TrackedLock (once) and mark
        the instance as instrumented."""
        inner = getattr(owner, lock_attr, None)
        if inner is None or isinstance(inner, TrackedLock):
            return
        with self._mu:
            seq = self._by_class_seq.get(cls.__name__, 0)
            self._by_class_seq[cls.__name__] = seq + 1
        name = f"{cls.__name__}.{lock_attr}#{seq}"
        object.__setattr__(owner, lock_attr, TrackedLock(inner, name, self))
        self._instances[id(owner)] = f"{cls.__name__}#{seq}"
        object.__setattr__(owner, "_schedlint_tracked", True)

    # -- the access checkpoint -----------------------------------------------

    @staticmethod
    def _caller_site() -> Optional[Site]:
        """The first frame outside this module — the mutation site."""
        try:
            fr = sys._getframe(2)
            while fr is not None and fr.f_code.co_filename == __file__:
                fr = fr.f_back
            if fr is None:
                return None
            return (fr.f_code.co_filename, fr.f_lineno, fr.f_code.co_name)
        except Exception:
            return None

    def record_access(self, owner: object, fieldname: str, write: bool) -> None:
        if not getattr(owner, "_schedlint_tracked", False):
            return
        if id(owner) not in self._instances:
            # instrumented by a DIFFERENT detector instance: its lock
            # reports to that detector's held stacks, so judging it
            # against this one's (empty) stacks would fabricate races
            return
        if self._quarantined():
            return
        st = self._thread_state()
        held = frozenset(lk.name for lk in st.stack)
        tid = st.token
        tname = threading.current_thread().name
        site = self._caller_site()
        key = (id(owner), fieldname)
        with self._mu:
            self._lockset_check(key, tid, tname, held, write, owner)
            self._hb_check(key, st, tname, write, site, owner)
        hook = _sched_hook
        if hook is not None and hook.controls_current_thread():
            hook.preempt(f"access:{fieldname}")

    def _lockset_check(self, key, tid, tname, held, write, owner) -> None:
        # caller holds _mu
        st = self._fields.setdefault(key, _FieldState())
        st.threads.add(tname)
        if st.state == _VIRGIN:
            st.state = _EXCLUSIVE
            st.first_thread = tid
            st.lockset = held
            return
        st.lockset = (st.lockset & held) if st.lockset is not None else held
        if st.state == _EXCLUSIVE:
            if tid == st.first_thread:
                return
            st.state = _SHARED_MODIFIED if write else _SHARED
        elif st.state == _SHARED and write:
            st.state = _SHARED_MODIFIED
        if st.state == _SHARED_MODIFIED and not st.lockset and not st.reported:
            st.reported = True
            self.races.append(
                RaceReport(
                    owner=self._instances.get(id(owner), type(owner).__name__),
                    field=key[1],
                    threads=tuple(sorted(st.threads)),
                    note="candidate lockset became empty",
                )
            )

    def _hb_check(self, key, st: _ThreadState, tname, write, site, owner) -> None:
        # caller holds _mu.  Race iff a prior conflicting access by
        # another thread is NOT ordered before this one: its epoch
        # exceeds this thread's vector-clock entry for that thread.
        hb = self._hb_fields.setdefault(key, _HbFieldState())
        tid = st.token
        epoch = st.vc[tid]
        if not hb.reported:
            conflicting = [(u, e, True) for u, e in hb.writes.items()]
            if write:
                conflicting += [(u, e, False) for u, e in hb.reads.items()]
            for utok, (uepoch, usite, uname), is_prior_write in conflicting:
                if utok == tid or uepoch <= st.vc.get(utok, 0):
                    continue
                hb.reported = True
                self.hb_races.append(
                    HbRaceReport(
                        owner=self._instances.get(id(owner), type(owner).__name__),
                        field=key[1],
                        first_thread=uname,
                        first_site=usite,
                        first_write=is_prior_write,
                        second_thread=tname,
                        second_site=site,
                        second_write=write,
                    )
                )
                break
        if write:
            hb.writes[tid] = (epoch, site, tname)
            # a write supersedes this thread's read entry (the write
            # conflicts with strictly more than the read did)
            hb.reads.pop(tid, None)
        else:
            hb.reads[tid] = (epoch, site, tname)

    # -- reporting ------------------------------------------------------------

    def clean(self) -> bool:
        return (
            not self.races
            and not self.hb_races
            and not self.lock_order_violations
        )

    def report_lines(self) -> List[str]:
        return (
            [str(r) for r in self.races]
            + [str(r) for r in self.hb_races]
            + [str(v) for v in self.lock_order_violations]
        )


# -- module-level switchboard -------------------------------------------------

_active: Optional[RaceDetector] = None

# cooperative-scheduler hook (the model checker).  The contract is tiny:
#   controls_current_thread() -> bool   — is this thread under control?
#   preempt(label)                      — a scheduling point
#   wait_for_lock(tracked_lock)         — yield until the lock may be free
#   lock_acquired(tracked_lock)         — a controlled thread now holds it
#   lock_released(tracked_lock)         — a controlled thread released it
_sched_hook: Optional[Any] = None


def set_sched_hook(hook) -> None:
    """Install (or clear, with ``None``) the cooperative scheduler hook
    consulted at every tracked acquire/release and access checkpoint.
    Only the model checker should ever set this."""
    global _sched_hook
    _sched_hook = hook


def active() -> bool:
    return _active is not None


def get() -> Optional[RaceDetector]:
    return _active


def enable(detector: Optional[RaceDetector] = None) -> RaceDetector:
    """Install ``detector`` (or a fresh one) as the process-wide race
    detector.  Idempotent: enabling while active keeps the existing
    detector unless a new one is passed explicitly."""
    global _active
    if detector is not None:
        _active = detector
    elif _active is None:
        _active = RaceDetector()
    return _active


def disable() -> Optional[RaceDetector]:
    """Deactivate and return the detector (for post-run assertions)."""
    global _active
    d, _active = _active, None
    return d


def enable_if_env() -> Optional[RaceDetector]:
    """Harness hook: enable when ``SCHEDLINT_RACECHECK`` is set."""
    return enable() if enabled_via_env() else None


def instrument_instance(owner: object, cls: type, lock_attr: str) -> None:
    d = _active
    if d is not None:
        d.register_instance(owner, cls, lock_attr)


def note_access(owner: object, fieldname: str, write: bool = True) -> None:
    """Instrumentation checkpoint placed inside shared-state mutators.
    Near-zero cost while the detector is inactive."""
    d = _active
    if d is not None:
        d.record_access(owner, fieldname, write)


def track_extra_lock(owner: object, lock_attr: str) -> None:
    """Module-level convenience for :meth:`RaceDetector.track_extra_lock`."""
    d = _active
    if d is not None:
        d.track_extra_lock(owner, lock_attr)


# the model checker's per-thread run registry: hosted HERE (a module
# that is only ever loaded once) so ``python -m …analysis.modelcheck``
# — which loads modelcheck.py twice, as __main__ and canonically — has
# one registry, not two (see modelcheck._run_tls)
_modelcheck_run_tls = threading.local()

_channel_seq = itertools.count(1)


def channel_token() -> int:
    """Process-unique id for building happens-before channel keys.
    Prefer ``("kind", channel_token())`` captured at ``__init__`` over
    ``("kind", id(self))``: object ids are recycled, and a recycled id
    would hand a dead channel's clock to an unrelated new object,
    fabricating ordering edges."""
    return next(_channel_seq)


def hb_publish(channel) -> None:
    """Record a happens-before *publish* on ``channel`` (any hashable):
    everything the calling thread did so far is ordered before any
    subsequent :func:`hb_observe` of the same channel.  Place this at
    the sending side of synchronization the lock tracker cannot see —
    an ``Event.set``, a queue put, a durable-file append."""
    d = _active
    if d is not None:
        d.channel_publish(channel)


def hb_observe(channel) -> None:
    """The receiving side of :func:`hb_publish`: joins every prior
    publish of ``channel`` into the calling thread's clock."""
    d = _active
    if d is not None:
        d.channel_observe(channel)


def hb_snapshot():
    """Capture the calling thread's clock for an item-carried handoff
    edge: stash the result inside whatever is handed to the consumer (a
    queue closure), and have the consumer call :func:`hb_join` on it.
    Unlike a channel publish, the edge exists exactly iff the handoff
    happened — a failed non-blocking put just drops the snapshot."""
    d = _active
    if d is not None:
        return d.channel_snapshot()
    return None


def hb_join(snapshot) -> None:
    """Consumer side of :func:`hb_snapshot`: join the producer's
    captured clock into the calling thread."""
    d = _active
    if d is not None and snapshot is not None:
        d.join_snapshot(snapshot)


# -- threading.Thread start/join hooks ---------------------------------------
#
# Installed once, on first detector construction; the wrappers cost one
# module-attribute read when no detector is active, mirroring
# note_access's disabled cost.  They give the HB detector its fork/join
# edges without requiring scenarios to call anything.

_thread_hooks_installed = False


def _install_thread_hooks() -> None:
    global _thread_hooks_installed
    if _thread_hooks_installed:
        return
    _thread_hooks_installed = True
    orig_start = threading.Thread.start
    orig_join = threading.Thread.join

    def start(self, *args, **kwargs):
        d = _active
        if d is not None:
            d._on_thread_start(self)
        return orig_start(self, *args, **kwargs)

    def join(self, *args, **kwargs):
        result = orig_join(self, *args, **kwargs)
        d = _active
        if d is not None and not self.is_alive():
            d._on_thread_join(self)
        return result

    start.__wrapped__ = orig_start  # type: ignore[attr-defined]
    join.__wrapped__ = orig_join    # type: ignore[attr-defined]
    threading.Thread.start = start  # type: ignore[method-assign]
    threading.Thread.join = join    # type: ignore[method-assign]
