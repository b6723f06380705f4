"""The anomaly flight recorder: replayable decision bundles.

A :class:`DecisionBundle` is the complete, self-contained input of one
queue solve — the scaled availability basis, driver ranks, executor
eligibility, the packed app rows — plus the verdicts the production
solve produced.  The :class:`FlightRecorder` keeps a bounded ring of the
most recent bundles and, when a trigger fires (deadline exceeded,
circuit breaker open, warm≠cold parity mismatch), persists the ring as
one JSONL file: one bundle per line, deterministic key order, diffable.
The file format is the reference package's, so a bundle either package
wrote replays in the other.

:func:`replay_bundle_file` re-runs every bundle through the queue
kernel on the card (``cuda``) and through its plain PyTorch version
(``torch``) and compares both with the recorded verdicts byte for byte,
so a persisted anomaly is a reproducible artifact, not a log line.  (The
reference replays on its two native lanes, cold and warm; its ``sim
--replay-bundle`` command line has no counterpart here yet.)
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import timesource
from ..device import DeviceLike, lane_of, resolve_device

BUNDLE_SCHEMA = 1

_POLICY_NAMES = {0: "tightly-pack", 1: "distribute-evenly", 2: "minimal-fragmentation"}


def _host(x) -> np.ndarray:
    """A captured array on the host: device tensors are copied here, at
    persist or replay time, never on the decision path."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _avail_sha(avail_after) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(_host(avail_after), dtype=np.int32).tobytes()
    ).hexdigest()[:16]


class DecisionBundle:
    """Dict-shaped for JSONL friendliness; this class only builds and
    validates the shape.  Materialization is persist-time only: the
    ring holds array REFERENCES (the basis and packed rows are
    per-request host arrays; the driver indices and the availability
    after the queue are the launch's own output tensors, which no later
    launch writes), so noting a decision on the hot path costs a tuple
    append, not a device copy or a 10k-row list conversion."""

    @staticmethod
    def from_artifacts(artifacts, pod: str, outcome: str, seq: int,
                       t: float) -> dict:
        n_earlier = int(artifacts.n_earlier)
        feasible = np.asarray(artifacts.feasible, dtype=bool)[:n_earlier]
        didx = _host(artifacts.didx).astype(np.int32)[:n_earlier]
        return {
            "schema": BUNDLE_SCHEMA,
            "seq": int(seq),
            "pod": pod,
            "outcome": outcome,
            "t": float(t),
            "lane": artifacts.lane,
            "policy": _POLICY_NAMES.get(artifacts.policy_code, "unknown"),
            "policyCode": int(artifacts.policy_code),
            "nb": int(artifacts.basis.shape[0]),
            "na": int(artifacts.packed.shape[0]),
            "nEarlier": n_earlier,
            "contentKey": (
                list(artifacts.content_key) if artifacts.content_key else None
            ),
            "feedSeq": artifacts.feed_seq,
            "queueNames": list(artifacts.queue_names),
            "basis": artifacts.basis.astype(int).tolist(),
            "driverRank": artifacts.driver_rank.astype(int).tolist(),
            "execOk": [int(v) for v in artifacts.exec_ok],
            "apps8": artifacts.packed.astype(int).tolist(),
            "verdicts": {
                "feasible": [int(v) for v in feasible],
                "didx": didx.astype(int).tolist(),
                "resume": int(artifacts.resume),
                "availAfterSha": (
                    _avail_sha(artifacts.avail_after)
                    if artifacts.avail_after is not None
                    else None
                ),
            },
        }


class FlightRecorder:
    """Bounded ring of recent decision bundles + trigger-driven persist.

    Bundles over ``max_nodes`` are counted and skipped (a 100k-node
    basis is not a flight-recorder artifact); the ring and every
    persisted file are bounded by ``capacity`` bundles."""

    def __init__(
        self,
        capacity: int = 8,
        out_dir: Optional[str] = None,
        max_nodes: int = 4096,
        metrics=None,
    ):
        self._lock = threading.Lock()
        self._ring: deque = deque()
        self._capacity = max(1, int(capacity))
        self._seq = 0
        self._persist_seq = 0
        self.out_dir = out_dir
        self.max_nodes = int(max_nodes)
        self._metrics = metrics
        self.skipped_oversize = 0
        self.persisted_paths: List[str] = []

    def note(self, artifacts, pod: str, outcome: str) -> Optional[int]:
        """Add one decision's bundle to the ring; returns its seq (the
        DecisionRecord cross-reference) or None when skipped.  Hot-path
        cost is one tuple append — JSON materialization waits for a
        trigger (see DecisionBundle)."""
        if artifacts.basis.shape[0] > self.max_nodes:
            with self._lock:
                self.skipped_oversize += 1
            return None
        t = float(timesource.now())
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._ring.append((seq, artifacts, pod, outcome, t))
            while len(self._ring) > self._capacity:
                self._ring.popleft()
        return seq

    def persist(self, trigger: str, detail: str = "") -> Optional[str]:
        """Write the current ring as one JSONL file (newest last);
        returns the path, or None when the ring is empty or no out_dir
        is configured."""
        with self._lock:
            entries = list(self._ring)
        if not entries or not self.out_dir:
            return None
        with self._lock:
            # numbered only when a file will actually be written, so the
            # on-disk sequence has no gaps an operator could mistake for
            # lost bundles
            self._persist_seq += 1
            pseq = self._persist_seq
        bundles = [
            DecisionBundle.from_artifacts(art, pod, outcome, seq, t)
            for seq, art, pod, outcome, t in entries
        ]
        os.makedirs(self.out_dir, exist_ok=True)
        safe_trigger = "".join(
            c if c.isalnum() or c in "-_" else "-" for c in trigger
        )
        path = os.path.join(
            self.out_dir, f"bundle-{pseq:04d}-{safe_trigger}.jsonl"
        )
        header = {
            "schema": BUNDLE_SCHEMA,
            "header": True,
            "trigger": trigger,
            "detail": detail,
            "t": float(timesource.now()),
            "bundles": len(bundles),
        }
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(header, sort_keys=True, separators=(",", ":")) + "\n")
            for b in bundles:
                f.write(json.dumps(b, sort_keys=True, separators=(",", ":")) + "\n")
        os.replace(tmp, path)
        with self._lock:
            self.persisted_paths.append(path)
        if self._metrics is not None:
            from ..metrics import names as mnames

            self._metrics.counter(
                mnames.PROVENANCE_BUNDLE_PERSISTED, {"trigger": trigger}
            )
            self._metrics.gauge(
                mnames.PROVENANCE_BUNDLE_BYTES, float(os.path.getsize(path))
            )
        return path

    def stats(self) -> Dict:
        with self._lock:
            return {
                "size": len(self._ring),
                "capacity": self._capacity,
                "noted": self._seq,
                "skipped_oversize": self.skipped_oversize,
                "persisted": len(self.persisted_paths),
                # dedupe by array identity: bundles that share one basis
                # array count it once
                "ring_bytes": sum(
                    arr.nbytes
                    for arr in {
                        id(a): a
                        for e in self._ring
                        for a in (e[1].basis, e[1].packed)
                    }.values()
                ),
            }


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


def _replay_solve(policy_code: int, avail, rank, eok, earlier, device):
    """The bundle's queue through the port's queue pass on `device` (the
    stateless pass the delta-solve engine's parity guard runs too):
    (feasible, driver_idx, avail_after) on the host."""
    from ..ops.fifo_session import solve_packed_cold

    feasible, didx, after = solve_packed_cold(policy_code, avail, rank, eok, earlier, device=device)
    return feasible, didx, _host(after)


def replay_bundle(bundle: dict, device: DeviceLike = None) -> dict:
    """Re-run one bundle's decision deterministically and compare
    byte-for-byte against the recorded verdicts: through the queue
    kernel on ``device`` (None = CUDA) and, when that is not the CPU,
    through its plain PyTorch version on the CPU too.

    Returns {"pod", "seq", "ok", "mismatches": [str], "lanes": {...}},
    lanes keyed "cuda" (the kernel) and "torch" (the plain version).
    """
    from ..ops.batch_solver import mf_sentinel_safe

    device = resolve_device(device)
    mismatches: List[str] = []
    lanes: Dict[str, str] = {}

    avail = np.array(bundle["basis"], dtype=np.int32).reshape(-1, 3)
    rank = np.array(bundle["driverRank"], dtype=np.int32)
    eok = np.array(bundle["execOk"], dtype=np.uint8).astype(bool)
    apps8 = np.array(bundle["apps8"], dtype=np.int32).reshape(-1, 8)
    n_earlier = int(bundle["nEarlier"])
    policy_code = int(bundle["policyCode"])
    want_feas = np.array(bundle["verdicts"]["feasible"], dtype=bool)
    want_didx = np.array(bundle["verdicts"]["didx"], dtype=np.int32)
    want_sha = bundle["verdicts"].get("availAfterSha")

    earlier = apps8[:n_earlier]

    def compare(lane: str, feas, didx, after) -> None:
        before = len(mismatches)
        got_feas = np.asarray(feas, dtype=bool)[:n_earlier]
        got_didx = np.asarray(didx, dtype=np.int32)[:n_earlier]
        if got_feas.tobytes() != want_feas.tobytes():
            mismatches.append(f"{lane}: feasible verdicts differ")
        if got_didx.tobytes() != want_didx.tobytes():
            mismatches.append(f"{lane}: driver indices differ")
        if want_sha is not None and _avail_sha(after) != want_sha:
            mismatches.append(f"{lane}: post-queue availability differs")
        lanes[lane] = "ok" if len(mismatches) == before else "mismatch"

    if policy_code == 2 and not mf_sentinel_safe(avail):
        # the min-frag kernels' drain keeps an int32 sentinel that a
        # capacity of this basis could reach (the solver never serves
        # such a basis on its kernel lane)
        mismatches.append("min-frag basis reaches the drain's sentinel: not replayable")
        lanes["torch"] = "unsupported"
    else:
        devices = [device] if device.type == "cpu" else [device, torch.device("cpu")]
        for d in devices:
            compare(lane_of(d), *_replay_solve(policy_code, avail, rank, eok, earlier, d))

    return {
        "pod": bundle.get("pod", ""),
        "seq": bundle.get("seq"),
        "policy": bundle.get("policy"),
        "nEarlier": n_earlier,
        "ok": not mismatches,
        "mismatches": mismatches,
        "lanes": lanes,
    }


def replay_bundle_file(path: str, device: DeviceLike = None) -> List[dict]:
    """Replay every bundle in a persisted JSONL file (header line
    skipped) on ``device`` (see replay_bundle); returns the per-bundle
    results."""
    results = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if obj.get("header"):
                continue
            results.append(replay_bundle(obj, device=device))
    return results
