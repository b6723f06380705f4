"""Durable intent journal for diverted write-back requests.

When the write-back circuit breaker opens (or a request exhausts its
retries), the reservation write is *diverted* here instead of being
dropped: the intent — operation, key, and the object's wire form — is
appended to a framed JSONL file (or kept in memory when no path is
configured) and replayed idempotently once the API server recovers, or
by the next scheduler instance on failover.

File format: one framed record per line, append-only while running::

    f1 <crc32 hex8> <payload bytes> <payload json>

- the payload ``{"a": "put", "seq": N, "op": "create|update|delete",
  "kind": …, "ns": …, "name": …, "obj": {…wire…}}`` is a pending
  intent; the latest put per (ns, name) wins (an app created then
  deleted during an outage nets out to the delete);
- ``{"a": "ack", "seq": N}`` — the intent landed at the API server;
- bare ``{…}`` lines (the pre-framing format) still load, so a journal
  written by an older build replays across an upgrade-failover.

Recovery verifies each frame's length and CRC32; the first bad record
marks a **torn tail** — the process died mid-append — and everything
from that point is truncated with a warning (and counted) instead of
feeding half a record to ``json.loads``.  Loading compacts; while
running, the journal re-compacts opportunistically on the ack path once
acked records exceed a configurable fraction of the file, so journals
stop growing unbounded across failovers.

When a fencing gate is installed (HA wiring), acks are **fenced**: a
deposed leader cannot ack an intent out from under the successor that
will replay it.  Put and ack records are then stamped with the writer's
fencing epoch (an ``"epoch"`` key) for the post-failover audit trail, as
the reference package stamps them: a journal either package wrote loads
in the other.

Exactly-once at the CRD level comes from replaying through the
idempotent write path (create → AlreadyExists folds the server copy;
delete → NotFound is success), not from the journal itself.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import zlib
from typing import Dict, List, Optional, Set, Tuple

from ..analysis import racecheck
from ..analysis.guarded import guarded_by
from ..ha import crashpoint

logger = logging.getLogger(__name__)

Key = Tuple[str, str]  # (namespace, name)

FRAME_MAGIC = "f1"

# create/update collapse to one ack class: both assert "the store's
# content for this key is now at the server", and the queue already
# dedupes them per key
_UPSERT = "upsert"


def _op_class(op: str) -> str:
    return "delete" if op == "delete" else _UPSERT


def _frame(payload: str) -> str:
    raw = payload.encode("utf-8")
    return f"{FRAME_MAGIC} {zlib.crc32(raw):08x} {len(raw)} {payload}\n"


def _unframe(line: str) -> Optional[dict]:
    """Parse one framed (or legacy bare-JSON) line; None = corrupt."""
    if line.startswith(FRAME_MAGIC + " "):
        parts = line.split(" ", 3)
        if len(parts) != 4:
            return None
        _, crc_hex, length, payload = parts
        raw = payload.encode("utf-8")
        try:
            if len(raw) != int(length) or zlib.crc32(raw) != int(crc_hex, 16):
                return None
        except ValueError:
            return None
        try:
            return json.loads(payload)
        except json.JSONDecodeError:
            return None
    if line.startswith("{"):  # legacy unframed record
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            return None
    return None


@guarded_by("_lock", "_pending", "_seq", "_fh", "_file_records")
class IntentJournal:
    def __init__(
        self,
        path: Optional[str] = None,
        metrics=None,
        compact_fraction: float = 0.5,
        compact_min_records: int = 64,
    ):
        self._path = path
        self._metrics = metrics
        self._compact_fraction = compact_fraction
        self._compact_min_records = compact_min_records
        self._lock = threading.Lock()
        # persist→replay happens-before channel; a process-unique token
        # so a recycled object id can never alias journals
        self._hb_key = ("journal", racecheck.channel_token())
        self._seq = 0
        # key → intent dict (latest wins)
        self._pending: Dict[Key, dict] = {}
        self._fh = None
        # records in the file since the last rewrite (puts + acks);
        # drives the acked-fraction compaction trigger
        self._file_records = 0
        # HA hooks, installed by server wiring when the fabric is on:
        # epoch_source stamps put/ack records, fence_gate refuses acks
        # from a deposed leader (ha/fencing.FencedWriter)
        self.epoch_source = None
        self.fence_gate = None
        if path:
            self._load()

    # -- persistence ---------------------------------------------------------

    def _load(self) -> None:
        pending: Dict[Key, dict] = {}
        by_seq: Dict[int, Key] = {}
        max_seq = 0
        torn = False
        if os.path.exists(self._path):
            with open(self._path) as f:
                lines = f.readlines()
            for i, line in enumerate(lines):
                line = line.strip()
                if not line:
                    continue
                rec = _unframe(line)
                if rec is None:
                    # torn tail: the process died mid-append.  Recovery
                    # keeps the good prefix and drops everything from
                    # the first bad record — trailing bytes after a torn
                    # frame are unordered garbage, not intents.
                    dropped = len(lines) - i
                    logger.warning(
                        "journal %s: torn tail at record %d — truncating "
                        "%d trailing line(s)",
                        self._path,
                        i,
                        dropped,
                    )
                    torn = True
                    break
                seq = int(rec.get("seq", 0))
                max_seq = max(max_seq, seq)
                if rec.get("a") == "put":
                    key = (rec.get("ns", ""), rec.get("name", ""))
                    pending[key] = rec
                    by_seq[seq] = key
                elif rec.get("a") == "ack":
                    key = by_seq.get(seq)
                    if key is not None and pending.get(key, {}).get("seq") == seq:
                        pending.pop(key, None)
        # under the lock even though _load only runs from __init__: the
        # lock is the declared guard for this state and holding it here
        # keeps the discipline uniform
        with self._lock:
            self._pending = pending
            self._seq = max_seq
            # compact: rewrite only the still-pending intents so the file
            # doesn't grow across restarts (this also truncates any torn
            # tail — the rewrite persists exactly the verified prefix
            # state)
            self._rewrite_locked()
            self._report_depth()
        if torn and self._metrics is not None:
            from ..metrics import names as mnames

            self._metrics.counter(mnames.RESILIENCE_JOURNAL_TORN_TAIL)

    def _rewrite_locked(self) -> None:
        """Rewrite the file to pending-only records (caller holds lock)."""
        if self._fh is not None:
            self._fh.close()
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            for rec in self._pending.values():
                f.write(_frame(json.dumps(rec, sort_keys=True)))
        os.replace(tmp, self._path)
        self._fh = open(self._path, "a")  # schedlint: disable=LK001 -- _rewrite_locked is only called with _lock held (see callers)
        self._file_records = len(self._pending)  # schedlint: disable=LK001 -- _rewrite_locked is only called with _lock held (see callers)

    def _append_line(self, rec: dict) -> None:
        if self._fh is not None:
            self._fh.write(_frame(json.dumps(rec, sort_keys=True)))
            self._fh.flush()
            self._file_records += 1  # schedlint: disable=LK001 -- _append_line is only called with _lock held (see callers)

    def _maybe_compact_locked(self) -> None:
        """Opportunistic compaction on the ack path (async worker
        threads — off the decision path): once acked records exceed the
        configured fraction of the file, rewrite pending-only."""
        if self._fh is None or self._file_records < self._compact_min_records:
            return
        # every file record beyond the live pending set is an acked put,
        # a superseded put, or an ack marker — all dead weight
        dead = self._file_records - len(self._pending)
        if dead / self._file_records < self._compact_fraction:
            return
        self._rewrite_locked()
        if self._metrics is not None:
            from ..metrics import names as mnames

            self._metrics.counter(mnames.RESILIENCE_JOURNAL_COMPACTIONS)

    # -- recording -----------------------------------------------------------

    def record(
        self, op: str, kind: str, namespace: str, name: str, obj_wire: Optional[dict]
    ) -> None:
        """Divert one write intent (latest-wins per key)."""
        crashpoint.maybe_crash(crashpoint.JOURNAL_PRE_APPEND)
        epoch_source = self.epoch_source
        with self._lock:
            racecheck.note_access(self, "_pending")
            self._seq += 1
            rec = {
                "a": "put",
                "seq": self._seq,
                "op": op,
                "kind": kind,
                "ns": namespace,
                "name": name,
                "obj": obj_wire,
            }
            if epoch_source is not None:
                rec["epoch"] = epoch_source()
            self._pending[(namespace, name)] = rec
            self._append_line(rec)
            racecheck.hb_publish(self._hb_key)
            self._report_depth()
            if self._metrics is not None:
                from ..metrics import names as mnames

                self._metrics.counter(
                    mnames.RESILIENCE_JOURNAL_APPENDED, {"op": op, "kind": kind}
                )
        crashpoint.maybe_crash(crashpoint.JOURNAL_POST_APPEND)

    def ack(self, op: str, namespace: str, name: str) -> bool:
        """Mark the pending intent for a key as landed.  Only acks when
        the landed operation's class matches the pending intent's (an
        upsert landing must not ack a newer pending delete).  Fenced
        when HA is wired: a deposed leader's ack would erase an intent
        the successor is about to replay."""
        gate = self.fence_gate
        if gate is not None:
            gate.check("journal.ack")  # raises StaleEpochError when deposed
        crashpoint.maybe_crash(crashpoint.JOURNAL_PRE_ACK)
        epoch_source = self.epoch_source
        with self._lock:
            racecheck.note_access(self, "_pending")
            key = (namespace, name)
            rec = self._pending.get(key)
            if rec is None or _op_class(rec["op"]) != _op_class(op):
                return False
            del self._pending[key]
            ack_rec: dict = {"a": "ack", "seq": rec["seq"]}
            if epoch_source is not None:
                ack_rec["epoch"] = epoch_source()
            self._append_line(ack_rec)
            self._report_depth()
            if self._metrics is not None:
                from ..metrics import names as mnames

                self._metrics.counter(mnames.RESILIENCE_JOURNAL_REPLAYED)
            self._maybe_compact_locked()
        crashpoint.maybe_crash(crashpoint.JOURNAL_POST_ACK)
        return True

    # -- introspection -------------------------------------------------------

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def file_records(self) -> int:
        with self._lock:
            return self._file_records

    def pending(self) -> List[dict]:
        """Copies of pending intents in seq order."""
        racecheck.hb_observe(self._hb_key)
        with self._lock:
            return sorted((dict(r) for r in self._pending.values()), key=lambda r: r["seq"])

    def pending_keys(self) -> Set[Key]:
        with self._lock:
            return set(self._pending)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def _report_depth(self) -> None:
        # caller holds the lock
        if self._metrics is not None:
            from ..metrics import names as mnames

            self._metrics.gauge(
                mnames.RESILIENCE_JOURNAL_DEPTH, float(len(self._pending))
            )
