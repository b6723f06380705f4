"""FIFO-ordered commit gate: linearizable turn-taking for admission (a
copy of the reference package's ``concurrent/commitgate.py``).

Tickets are issued at request arrival under the gate lock, so the gate
order *is* the arrival order.  Commits then execute strictly in ticket
order: :meth:`CommitGate.await_turn` parks a request until every earlier
ticket has retired, and :meth:`CommitGate.retire` advances the head past
the retiring ticket (and past any earlier-aborted tickets), waking
exactly the new head.  The short commit critical section this enforces
replaces solver tenure under the predicate lock.

Aborts compose: a request whose deadline expires before its turn (or
whose speculation is cancelled) retires without committing and later
tickets skip over it — FIFO among *committed* requests is preserved.

Waiting is pluggable (``event_factory``): production uses
``threading.Event``; a cooperative scheduler can inject its own event so
parked turns stay visible to it.

:class:`CommitIntent` is the multi-active envelope: a standby replica's
speculative verdict plus the fencing epoch it was served under.  The
committer refuses intents from a stale epoch before they ever reach the
gate (and the :class:`~..ha.fencing.FencedWriter` on the write-back
path refuses the actual write by construction)."""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Set

from ..analysis.guarded import guarded_by


@dataclass
class CommitIntent:
    """A speculative verdict forwarded for epoch-fenced commitment.

    ``epoch`` is the fencing epoch the speculation was served under
    (the sender's view of the current leadership term); the committer
    compares it against the live epoch and refuses mismatches —
    a deposed replica's intents can never land after failover."""

    pod_name: str
    namespace: str
    epoch: int
    args: Any = None
    verdict: Any = None
    origin: str = ""


@guarded_by(
    "_lock",
    "_next_ticket",
    "_head",
    "_retired",
    "_waiters",
    "_committed_total",
    "_aborted_total",
    "_max_queue_depth",
)
class CommitGate:
    """Ticket dispenser + FIFO turn-keeper for admission commits."""

    def __init__(self, event_factory: Callable[[], Any] = threading.Event):
        self._lock = threading.Lock()
        self._event_factory = event_factory
        # next ticket to issue (arrival order) / next ticket to commit
        self._next_ticket = 0
        self._head = 0
        # tickets that retired ahead of becoming head (aborts, or the
        # head itself mid-advance); drained by the head-advance loop
        self._retired: Set[int] = set()
        # ticket -> park event, registered under the lock so a retire
        # that advances the head can never miss a waiter (the event is
        # sticky: set-before-wait still wakes)
        self._waiters: Dict[int, Any] = {}
        self._committed_total = 0
        self._aborted_total = 0
        self._max_queue_depth = 0

    # -- tickets ----------------------------------------------------------

    def ticket(self) -> int:
        """Issue the next FIFO ticket; the issue order is the commit
        order."""
        with self._lock:
            t = self._next_ticket
            self._next_ticket += 1
            depth = self._next_ticket - self._head
            if depth > self._max_queue_depth:
                self._max_queue_depth = depth
            return t

    def head(self) -> int:
        with self._lock:
            return self._head

    def depth(self) -> int:
        """Tickets issued but not yet retired."""
        with self._lock:
            return self._next_ticket - self._head - len(self._retired)

    # -- turn-taking ------------------------------------------------------

    def await_turn(self, ticket: int) -> None:
        """Park until ``ticket`` is the commit head.  Returns
        immediately when it already is (the common uncontended case)."""
        with self._lock:
            if self._head == ticket:
                return
            ev = self._waiters.setdefault(ticket, self._event_factory())
        ev.wait()

    def retire(self, ticket: int, committed: bool) -> None:
        """Mark ``ticket`` finished (committed or aborted) and advance
        the head past every contiguously-retired ticket, waking the new
        head's waiter if one is parked."""
        wake = None
        with self._lock:
            self._retired.add(ticket)
            if committed:
                self._committed_total += 1
            else:
                self._aborted_total += 1
            while self._head in self._retired:
                self._retired.discard(self._head)
                self._waiters.pop(self._head, None)
                self._head += 1
            wake = self._waiters.get(self._head)
        if wake is not None:
            wake.set()

    # -- observability ----------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "issued": self._next_ticket,
                "head": self._head,
                "committed": self._committed_total,
                "aborted": self._aborted_total,
                "max_queue_depth": self._max_queue_depth,
            }
