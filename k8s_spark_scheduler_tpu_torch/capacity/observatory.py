"""The capacity observatory sampler: fragmentation / headroom / queue
pressure as a queryable cluster-state timeline (the reference
package's ``capacity/observatory.py``).

Sampling discipline:

- **Only on state change.**  The tensor mirror's ChangeFeed sequence is
  the trigger: an unchanged sequence proves an unchanged world, so
  ``maybe_sample`` is O(1) then.  The background thread parks on an
  Event the feed sets on publish, with a debounce so event bursts
  (a gang's worth of reservation writes) produce one sample.
- **Never under the extender lock.**  The sampler probes a snapshot —
  a consistent copy — so it needs no scheduling lock at all; the
  thread-local tenure flag (capacity/__init__) turns any accidental
  in-lock invocation into a counted refusal instead of lock-hold time.
- **Off the Filter's stream.**  On a CUDA device the probes run on the
  sampler's own CUDA stream: the snapshot is uploaded once, the
  cluster-wide and per-(instance-group, zone) frag reports and headroom
  searches are one program over every segment and shape with no host
  synchronisation inside the bisection, and the results come back in
  one copy — a sample never holds up a Filter's launch on the default
  stream.
- **Bounded everywhere.**  Probe shapes, (instance-group, zone) combos,
  and queue forecasts are capped (dropped counts are reported, never
  silent); the timeline is a ring keyed by (ChangeFeed sequence,
  snapshot content_key).

The per-node Python loops of the reference's per-group and tenant
attribution are array work here, over a group-id array and a combo
layout cached per snapshot ``structure_key``; the outputs are the
reference's.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import timesource
from ..analysis import racecheck
from ..analysis.guarded import guarded_by
from ..device import DeviceLike, lane_of, resolve_device
from ..metrics import names as mnames
from ..ops.classes import group_rows
from . import in_predicate_lock
from .probe import DEFAULT_K_MAX, frag_segments, probe_segments

logger = logging.getLogger(__name__)

DIM_NAMES = ("cpu", "memory", "nvidia.com/gpu")


def shape_key(driver_row, executor_row) -> str:
    """Deterministic label-safe key for a (driver, executor) resource
    shape in base units (milli-cpu / bytes / milli-gpu)."""
    d = tuple(int(x) for x in driver_row)
    e = tuple(int(x) for x in executor_row)
    return f"d{d[0]}.{d[1]}.{d[2]}-e{e[0]}.{e[1]}.{e[2]}"


@dataclass
class CapacitySample:
    """One point of the cluster-state timeline (plain data — every
    field JSON-serializable via :meth:`to_dict`)."""

    seq: int                      # ChangeFeed sequence at snapshot time
    content_key: Tuple            # (mirror instance, seq) — the exact state id
    structure_key: Tuple
    t: float                      # timesource.now()
    trigger: str
    nodes: int = 0
    ready_nodes: int = 0
    free: Tuple[int, ...] = (0, 0, 0)             # per-dim total free
    largest_chunk: Tuple[int, ...] = (0, 0, 0)    # per-dim best single node
    usable_free_nodes: Tuple[int, ...] = (0, 0, 0)
    overdrawn_nodes: Tuple[int, ...] = (0, 0, 0)
    frag_index: Tuple[float, ...] = (0.0, 0.0, 0.0)
    # shape_key -> {"headroom": int, "usable": [3], "probes": int}
    headroom: Dict[str, Dict] = field(default_factory=dict)
    # "group|zone" -> {"nodes", "free", "largestChunk", "fragIndex",
    #                  "headroom": {shape_key: int}}
    groups: Dict[str, Dict] = field(default_factory=dict)
    # instance group -> {"used": [3], "allocatable": [3], "utilization",
    #                    "share": [3]}
    tenants: Dict[str, Dict] = field(default_factory=dict)
    # equivalence-class lane: {"count", "ratio", "indexCount",
    # "indexRatio", "free", "largestChunk", "fragIndex",
    # "headroom": {shape_key: int}, "expandMs"} — O(classes) twins of
    # the row-level analytics above, multiplicity-weighted
    classes: Dict = field(default_factory=dict)
    queue: List[Dict] = field(default_factory=list)
    queue_truncated: int = 0      # pending drivers beyond max_queue
    queued_gangs: int = 0
    pressure: int = 0             # queued gangs that do NOT fit right now
    probe_solves: int = 0
    probe_lane: str = ""
    shapes_dropped: int = 0
    groups_dropped: int = 0
    sample_ms: float = 0.0        # wall cost (diagnostic; not replayed)

    def to_dict(self) -> Dict:
        return {
            "seq": self.seq,
            "contentKey": list(self.content_key),
            "structureKey": list(self.structure_key),
            "t": self.t,
            "trigger": self.trigger,
            "nodes": self.nodes,
            "readyNodes": self.ready_nodes,
            "dims": list(DIM_NAMES),
            "free": [int(x) for x in self.free],
            "largestChunk": [int(x) for x in self.largest_chunk],
            "freeNodes": [int(x) for x in self.usable_free_nodes],
            "overdrawnNodes": [int(x) for x in self.overdrawn_nodes],
            "fragIndex": [round(float(x), 6) for x in self.frag_index],
            "headroom": self.headroom,
            "classes": self.classes,
            "groups": self.groups,
            "tenants": self.tenants,
            "queue": self.queue,
            "queueTruncated": self.queue_truncated,
            "queuedGangs": self.queued_gangs,
            "pressure": self.pressure,
            "probeSolves": self.probe_solves,
            "probeLane": self.probe_lane,
            "shapesDropped": self.shapes_dropped,
            "groupsDropped": self.groups_dropped,
            "sampleMs": round(self.sample_ms, 3),
        }


# default probe shape when the queue is empty: 1 CPU / 1 GiB / 0 GPU —
# the "could anything at all schedule" canary
_DEFAULT_SHAPE = (
    (1000, 1 << 30, 0),
    (1000, 1 << 30, 0),
)


@dataclass
class _Layout:
    """Structure-derived grouping of a snapshot's rows (valid while its
    ``structure_key`` holds): the kept (instance-group, zone) combos in
    sorted order, their rows concatenated, and the tenant group of every
    node."""

    combos: List[Tuple[str, str]]
    rows: np.ndarray               # rows of the kept combos, combo by combo
    offsets: List[int]             # len(combos) + 1 offsets into rows
    dropped: int
    tenant_names: List[str]        # sorted instance groups
    tenant_of: np.ndarray          # [N] index into tenant_names


def _layout(snap, group_label: str, max_group_zones: int) -> _Layout:
    groups = [labels.get(group_label, "") for labels in snap.labels]
    zone_names = list(snap.zone_names) + [""]
    zone_id = np.asarray(snap.zone_id, dtype=np.int64)
    zone_id = np.where((zone_id >= 0) & (zone_id < len(snap.zone_names)), zone_id, len(snap.zone_names))
    members: Dict[Tuple[str, str], List[int]] = {}
    for i, (group, zone) in enumerate(zip(groups, zone_id.tolist())):
        members.setdefault((group, zone_names[zone]), []).append(i)
    ordered = sorted(members)
    kept = ordered[:max_group_zones]
    rows = [np.asarray(members[c], dtype=np.int64) for c in kept]
    offsets = [0]
    for r in rows:
        offsets.append(offsets[-1] + len(r))
    tenant_names, tenant_of = np.unique(np.asarray(groups, dtype=object), return_inverse=True) \
        if groups else (np.zeros(0, dtype=object), np.zeros(0, dtype=np.int64))
    return _Layout(
        combos=kept,
        rows=np.concatenate(rows) if rows else np.zeros(0, dtype=np.int64),
        offsets=offsets,
        dropped=len(ordered) - len(kept),
        tenant_names=[str(g) for g in tenant_names],
        tenant_of=np.asarray(tenant_of, dtype=np.int64).reshape(-1),
    )


def _fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Every tensor in ONE device-to-host copy (int64, float64 bit-cast
    through int64), as numpy arrays of their shapes and dtypes."""
    flat = [t.reshape(-1).view(torch.int64) if t.dtype == torch.float64 else t.reshape(-1).to(torch.int64)
            for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        part = host[at : at + f.numel()]
        at += f.numel()
        if t.dtype == torch.float64:
            part = part.view(np.float64)
        out.append(part.reshape(tuple(t.shape)))
    return out


@guarded_by(
    "_lock",
    "_ring",
    "_stats",
    "_last_seq",
    "_prev_pending",
    "_departures",
    "_last_forecast_t",
)
class CapacitySampler:
    """See module docstring.  Thread model: ``maybe_sample`` /
    ``sample_now`` may be called from the background thread or an HTTP
    read; the ring and counters take the sampler lock, the probes
    themselves run lock-free on snapshot copies.  ``device`` is where
    the probes run (None = CUDA, which raises without it)."""

    def __init__(
        self,
        snapshot_cache,
        pod_lister=None,
        waste_reporter=None,
        metrics=None,
        instance_group_label: str = "",
        ring_size: int = 256,
        debounce_seconds: float = 0.25,
        interval_seconds: float = 15.0,
        max_shapes: int = 16,
        max_group_zones: int = 16,
        max_queue: int = 64,
        device: DeviceLike = None,
    ):
        self._cache = snapshot_cache
        self._pod_lister = pod_lister
        self._waste = waste_reporter
        self._metrics = metrics
        self._group_label = instance_group_label
        self.debounce_seconds = float(debounce_seconds)
        self.interval_seconds = float(interval_seconds)
        self.max_shapes = int(max_shapes)
        self.max_group_zones = int(max_group_zones)
        self.max_queue = int(max_queue)
        self.device = resolve_device(device)
        # the probes' own CUDA stream (made at the first sample)
        self._stream = None
        self._layout_cache: Optional[Tuple[Tuple, _Layout]] = None

        self._lock = threading.Lock()
        # serializes whole samples (snapshot → probe → append → publish):
        # the HTTP freshen path and the background thread may race past
        # maybe_sample's gate together; unserialized, the slower sampler
        # could append an OLDER seq after a newer one (breaking the
        # ring's order) and its off-lock publish could prune the gauge
        # series the fresh sample just wrote.  Never taken on a
        # scheduling path — only sampler callers block on it.
        self._sample_mutex = threading.Lock()
        self._ring: Deque[CapacitySample] = deque(maxlen=ring_size)
        self._last_seq = -1
        # the tensor mirror publishes NO delta for nodeless pods
        # (queued-driver heartbeats must not churn the solver's content
        # sequence), so queue changes are detected via the pod
        # informer's driver-bucket revision
        self._last_queue_rev = -1
        self._stats = {
            "samples": 0,
            "skipped_unchanged": 0,
            "lock_violations": 0,
            "probe_solves": 0,
            # the class lane is diagnostic: its failures are logged and
            # counted, never raised
            "class_lane_failures": 0,
        }
        # admission-rate source for the time-to-admit forecast: pods
        # that left the pending-driver set between samples.  Each entry
        # is (interval_start, count) — the START of the inter-sample
        # interval the departures happened in, not the observation
        # time, so the rate's denominator never collapses to ~0 on the
        # first observed departure.
        self._prev_pending: set = set()
        self._departures: Deque[Tuple[float, int]] = deque(maxlen=64)
        self._last_forecast_t: Optional[float] = None

        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        feed = getattr(snapshot_cache, "feed", None)
        if feed is not None and hasattr(feed, "attach_wakeup"):
            feed.attach_wakeup(self._wake)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="capacity-sampler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=5.0)

    def _loop(self) -> None:
        feed = getattr(self._cache, "feed", None)
        while not self._stop.is_set():
            fired = self._wake.wait(timeout=self.interval_seconds)
            if self._stop.is_set():
                return
            if fired:
                if feed is not None and hasattr(feed, "hb_channel"):
                    # the observe side of the feed's publish→wakeup edge
                    racecheck.hb_observe(feed.hb_channel())
                self._wake.clear()
                # debounce: let the burst (one gang = many deltas) land
                # before paying one sample for all of it
                if self.debounce_seconds > 0:
                    time.sleep(self.debounce_seconds)
                self._wake.clear()
            try:
                self.maybe_sample(trigger="feed" if fired else "interval")
            except Exception:
                logger.exception("capacity sample failed (diagnostic only)")

    # -- sampling ------------------------------------------------------------

    def _queue_rev(self) -> int:
        if self._pod_lister is None:
            return -1
        try:
            from ..scheduler import labels as L

            return self._pod_lister.informer.selector_revision(L.SPARK_ROLE_LABEL, L.DRIVER)
        except Exception:
            return -1

    def maybe_sample(self, trigger: str = "feed") -> Optional[CapacitySample]:
        """Sample iff the ChangeFeed moved OR the driver queue changed
        since the last sample — O(1) when nothing changed."""
        seq = self._cache.feed.seq
        rev = self._queue_rev()
        with self._lock:
            racecheck.note_access(self, "_stats")
            if seq == self._last_seq and rev == self._last_queue_rev:
                self._stats["skipped_unchanged"] += 1
                return None
        return self.sample_now(trigger=trigger)

    def sample_now(self, trigger: str = "manual") -> Optional[CapacitySample]:
        """Probe the current snapshot unconditionally (modulo the
        extender-lock refusal) and append to the timeline."""
        if in_predicate_lock():
            # NEVER probe while holding the extender lock: refuse,
            # count, and let the next off-lock trigger pick it up
            with self._lock:
                racecheck.note_access(self, "_stats")
                self._stats["lock_violations"] += 1
            return None
        with self._sample_mutex:
            t0 = time.perf_counter()
            queue_rev = self._queue_rev()
            snap = self._cache.snapshot()
            sample = self._build_sample(snap, trigger)
            sample.sample_ms = (time.perf_counter() - t0) * 1000.0
            with self._lock:
                racecheck.note_access(self, "_ring")
                if self._ring and self._ring[-1].seq == sample.seq:
                    # an unconditional (HTTP/forced) re-sample of
                    # unchanged state replaces rather than duplicates
                    # the timeline key
                    self._ring[-1] = sample
                else:
                    self._ring.append(sample)
                self._last_seq = sample.seq
                self._last_queue_rev = queue_rev
                self._stats["samples"] += 1
                self._stats["probe_solves"] += sample.probe_solves
            self._publish(sample)
        return sample

    # -- read side -----------------------------------------------------------

    def latest(self) -> Optional[CapacitySample]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def history(self, limit: Optional[int] = None) -> List[CapacitySample]:
        with self._lock:
            items = list(self._ring)
        items.reverse()  # newest first
        if limit is not None and limit >= 0:
            items = items[:limit]
        return items

    def timeline(self) -> List[CapacitySample]:
        """Oldest-first (the artifact order)."""
        with self._lock:
            return list(self._ring)

    def find(self, seq: int) -> Optional[CapacitySample]:
        with self._lock:
            for s in self._ring:
                if s.seq == seq:
                    return s
        return None

    def diff(self, from_seq: int, to_seq: int) -> Optional[Dict]:
        """What changed between two timeline points (exact seq keys;
        ``history`` lists the available ones)."""
        a = self.find(from_seq)
        b = self.find(to_seq)
        if a is None or b is None:
            return None
        shape_keys = sorted(set(a.headroom) | set(b.headroom))
        return {
            "from": a.seq,
            "to": b.seq,
            "structureChanged": a.structure_key != b.structure_key,
            "nodes": b.nodes - a.nodes,
            "readyNodes": b.ready_nodes - a.ready_nodes,
            "free": [int(y - x) for x, y in zip(a.free, b.free)],
            "largestChunk": [int(y - x) for x, y in zip(a.largest_chunk, b.largest_chunk)],
            "fragIndex": [round(float(y - x), 6) for x, y in zip(a.frag_index, b.frag_index)],
            "headroom": {
                k: (b.headroom.get(k, {}).get("headroom", 0) - a.headroom.get(k, {}).get("headroom", 0))
                for k in shape_keys
            },
            "pressure": b.pressure - a.pressure,
            "queuedGangs": b.queued_gangs - a.queued_gangs,
            "groupsAdded": sorted(set(b.groups) - set(a.groups)),
            "groupsRemoved": sorted(set(a.groups) - set(b.groups)),
        }

    def stats(self) -> Dict:
        with self._lock:
            out = dict(self._stats)
            out["ring"] = len(self._ring)
            out["ring_capacity"] = self._ring.maxlen
        return out

    @property
    def lock_violations(self) -> int:
        with self._lock:
            return self._stats["lock_violations"]

    # -- internals -----------------------------------------------------------

    def _pending_drivers(self) -> List:
        if self._pod_lister is None:
            return []
        from ..scheduler import labels as L

        drivers = self._pod_lister.list(label_selector={L.SPARK_ROLE_LABEL: L.DRIVER})
        pending = [p for p in drivers if p.node_name == "" and p.meta.deletion_timestamp is None]
        pending.sort(key=lambda p: (p.creation_timestamp, p.name))
        return pending

    def _gang_rows(self, pod):
        """(driver_row, executor_row, count) in base units, or None when
        the pod's annotations don't parse / aren't exact."""
        try:
            from ..ops.tensorize import _resources_to_base
            from ..scheduler.sparkpods import spark_app_demand_cached

            _, demand = spark_app_demand_cached(pod)
            drow, de = _resources_to_base(demand.driver_resources)
            erow, ee = _resources_to_base(demand.executor_resources)
            if not (de and ee):
                return None
            return (
                tuple(int(x) for x in drow),
                tuple(int(x) for x in erow),
                int(demand.min_executor_count),
            )
        except Exception:
            return None

    def _on_stream(self):
        """The probes' CUDA stream as the current stream (nothing on the
        CPU)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return torch.cuda.stream(self._stream)

    def _layout(self, snap) -> _Layout:
        cached = self._layout_cache
        if cached is None or cached[0] != tuple(snap.structure_key):
            cached = (tuple(snap.structure_key), _layout(snap, self._group_label, self.max_group_zones))
            self._layout_cache = cached
        return cached[1]

    def _build_sample(self, snap, trigger: str) -> CapacitySample:
        now = timesource.now()
        sample = CapacitySample(
            seq=int(snap.content_key[1]),
            content_key=tuple(snap.content_key),
            structure_key=tuple(snap.structure_key),
            t=now,
            trigger=trigger,
        )
        n = len(snap.names)
        avail = snap.avail
        eligible = snap.ready & ~snap.unschedulable
        sample.nodes = n
        sample.ready_nodes = int(eligible.sum())

        # gang shapes: the queued drivers' demands, bounded, else a canary
        pending = self._pending_drivers()
        sample.queued_gangs = len(pending)
        sample.queue_truncated = max(0, len(pending) - self.max_queue)
        # ALL pending gangs are shape-parsed (the demand parse is
        # per-pod cached — the FIFO path pays it anyway) so the
        # pressure gauge counts every known-not-fitting gang; only the
        # per-driver forecast ENTRIES are capped at max_queue
        gangs = []  # (pod, rows or None)
        shapes: Dict[str, Tuple] = {}
        dropped_shapes: set = set()
        for pod in pending:
            rows = self._gang_rows(pod)
            gangs.append((pod, rows))
            if rows is None:
                continue
            key = shape_key(rows[0], rows[1])
            if key not in shapes:
                if len(shapes) >= self.max_shapes:
                    dropped_shapes.add(key)
                    continue
                shapes[key] = (rows[0], rows[1])
        if not shapes:
            shapes[shape_key(*_DEFAULT_SHAPE)] = _DEFAULT_SHAPE
        sample.shapes_dropped = len(dropped_shapes)
        shape_list = sorted(shapes.items())
        shape_rows = np.array([list(d) + list(e) for _, (d, e) in shape_list], dtype=np.int64)

        layout = self._layout(snap)
        probing = n > 0 and sample.ready_nodes > 0
        with self._on_stream():
            self._row_level(avail, eligible, shape_list, shape_rows, layout, probing, sample)
            if n > 0:
                self._class_lane(snap, avail, eligible, shape_list, shape_rows, sample)
        self._tenants(snap, layout, sample)
        self._forecast(gangs, pending, sample, now)
        return sample

    def _row_level(self, avail, eligible, shape_list, shape_rows, layout, probing, sample) -> None:
        """The cluster-wide frag report and headroom search, and (when a
        node is ready) those of every kept (instance-group, zone) combo:
        one program over the cluster's rows followed by the combos'
        rows, one segment each, every shape at once."""
        dev = self.device
        n = avail.shape[0]
        rows = np.concatenate([np.arange(n, dtype=np.int64), layout.rows]) if probing else np.arange(n)
        offsets = [0, n] + ([n + o for o in layout.offsets[1:]] if probing else [])
        avail_t = torch.from_numpy(np.ascontiguousarray(avail[rows], dtype=np.int64)).to(dev)
        elig_t = torch.from_numpy(np.ascontiguousarray(eligible[rows], dtype=bool)).to(dev)
        ones = torch.ones(len(rows), dtype=torch.int64, device=dev)
        outs = list(frag_segments(avail_t, ones, elig_t, offsets))
        if probing:
            outs += probe_segments(avail_t, ones, elig_t, elig_t, offsets,
                                   torch.from_numpy(shape_rows).to(dev), DEFAULT_K_MAX)
        host = _fetch(outs)
        total, largest, free_nodes, overdrawn, frag = host[:5]
        sample.free = tuple(int(x) for x in total[0])
        sample.largest_chunk = tuple(int(x) for x in largest[0])
        sample.usable_free_nodes = tuple(int(x) for x in free_nodes[0])
        sample.overdrawn_nodes = tuple(int(x) for x in overdrawn[0])
        sample.frag_index = tuple(float(x) for x in frag[0])
        if not probing:
            sample.probe_lane = "empty"
            for key, _ in shape_list:
                sample.headroom[key] = {"headroom": 0, "usable": [0, 0, 0], "probes": 0}
            return
        headroom, usable, probes = host[5:]
        sample.probe_lane = lane_of(dev)
        sample.probe_solves = int(probes.sum())
        for i, (key, _) in enumerate(shape_list):
            sample.headroom[key] = {
                "headroom": int(headroom[0, i]),
                "usable": [int(x) for x in usable[0, i]],
                "probes": int(probes[0, i]),
            }
        sample.groups_dropped = layout.dropped
        for g, (group, zone) in enumerate(layout.combos, start=1):
            members = layout.rows[layout.offsets[g - 1] : layout.offsets[g]]
            ready = int(eligible[members].sum())
            entry = {
                "nodes": len(members),
                "readyNodes": ready,
                "free": [int(x) for x in total[g]],
                "largestChunk": [int(x) for x in largest[g]],
                "fragIndex": [round(float(x), 6) for x in frag[g]],
                "headroom": {},
            }
            if ready:
                for i, (key, _) in enumerate(shape_list):
                    entry["headroom"][key] = int(headroom[g, i])
            sample.groups["|".join((group, zone))] = entry

    def _class_lane(self, snap, avail, eligible, shape_list, shape_rows, sample) -> None:
        """Equivalence-class analytics: group nodes by exact
        (availability, schedulability) on the device and run the
        frag/headroom programs once per class with multiplicity
        weighting — O(classes) instead of O(nodes), identical results
        (tests/test_torch_classindex.py).  ``expandMs`` is this lane's
        whole wall cost: grouping + weighted probes + expanding class
        results back to the sample's node-level vocabulary."""
        t0 = time.perf_counter()
        try:
            dev = self.device
            avail_t = torch.from_numpy(np.ascontiguousarray(avail, dtype=np.int64)).to(dev)
            elig_t = torch.from_numpy(np.ascontiguousarray(eligible, dtype=bool)).to(dev)
            n_classes, cls, reps = group_rows(avail_t, elig_t)
            if n_classes <= 0:
                return
            mult = torch.bincount(cls, minlength=n_classes)
            class_avail, class_elig = avail_t[reps], elig_t[reps]
            offsets = [0, n_classes]
            outs = list(frag_segments(class_avail, mult, class_elig, offsets))
            probing = bool(eligible.any()) and bool(shape_list)
            if probing:
                outs += probe_segments(class_avail, mult, class_elig, class_elig, offsets,
                                       torch.from_numpy(shape_rows).to(dev), DEFAULT_K_MAX)
            host = _fetch(outs)
            total, largest, _, _, frag = host[:5]
            entry: Dict = {
                "count": int(n_classes),
                "ratio": round(len(snap.names) / n_classes, 3),
                "free": [int(x) for x in total[0]],
                "largestChunk": [int(x) for x in largest[0]],
                "fragIndex": [round(float(x), 6) for x in frag[0]],
                "headroom": {},
            }
            if probing:
                headroom, _, probes = host[5:]
                sample.probe_solves += int(probes.sum())
                for i, (key, _) in enumerate(shape_list):
                    entry["headroom"][key] = int(headroom[0, i])
            # the state-layer identity (rounded capacity × labels × AZ ×
            # schedulability, state/classindex.py) rides along: the
            # tpu.classes.{count,compression.ratio} gauges report IT —
            # the exact grouping above is the analytics lane's own key
            index = getattr(self._cache, "classes", None)
            if index is not None and hasattr(index, "stats"):
                n_cls, _n_nodes, ratio = index.stats()
                entry["indexCount"] = int(n_cls)
                entry["indexRatio"] = round(float(ratio), 3)
            entry["expandMs"] = round((time.perf_counter() - t0) * 1000.0, 3)
            sample.classes = entry
        except Exception:
            with self._lock:
                self._stats["class_lane_failures"] += 1
            logger.exception("class analytics lane failed (diagnostic only)")

    def _tenants(self, snap, layout: _Layout, sample) -> None:
        """Per-instance-group utilization attribution: who holds the
        reserved capacity (usage rows are hard + soft reservations)."""
        n_groups = len(layout.tenant_names)
        usage = np.maximum(np.asarray(snap.usage, dtype=np.int64), 0)
        alloc = np.maximum(np.asarray(snap.allocatable, dtype=np.int64), 0)
        cluster_used = usage.sum(axis=0)
        used_by = np.zeros((n_groups, 3), dtype=np.int64)
        alloc_by = np.zeros((n_groups, 3), dtype=np.int64)
        np.add.at(used_by, layout.tenant_of, usage)
        np.add.at(alloc_by, layout.tenant_of, alloc)
        for g, group in enumerate(layout.tenant_names):
            used, allocatable = used_by[g], alloc_by[g]
            with np.errstate(divide="ignore", invalid="ignore"):
                util = float(np.max(np.where(allocatable > 0, used / np.maximum(allocatable, 1), 0.0)))
                share = np.where(cluster_used > 0, used / np.maximum(cluster_used, 1), 0.0)
            sample.tenants[group] = {
                "used": [int(x) for x in used],
                "allocatable": [int(x) for x in allocatable],
                "utilization": round(util, 6),
                "share": [round(float(x), 6) for x in share],
            }

    def _forecast(self, gangs, pending, sample, now: float) -> None:
        """Time-to-admit forecast per queued driver: probe verdict ×
        demand fulfillment state × the observed departure rate."""
        current_keys = {(p.namespace, p.name) for p in pending}
        with self._lock:
            racecheck.note_access(self, "_prev_pending")
            departed = len(self._prev_pending - current_keys)
            prev_t = self._last_forecast_t
            if self._prev_pending and departed and prev_t is not None:
                self._departures.append((prev_t, departed))
            self._prev_pending = current_keys
            self._last_forecast_t = now
            window = list(self._departures)
        rate = 0.0
        if window:
            # span runs from the start of the earliest interval that
            # produced a departure — a real prior sample time, so one
            # observation yields departures-per-inter-sample-interval,
            # not departures-per-epsilon
            span = now - window[0][0]
            if span > 0:
                rate = sum(n for _, n in window) / span

        # pressure is accounted over EVERY pending gang whose shape was
        # probed — the autoscaler-facing backlog signal must not cap at
        # max_queue — while forecast entries are emitted only for the
        # first max_queue positions (queueTruncated counts the rest)
        pressure = 0
        for position, (pod, rows) in enumerate(gangs):
            emit = position < self.max_queue
            entry = {
                "pod": pod.name,
                "namespace": pod.namespace,
                "queuePosition": position,
                "ageSeconds": round(max(now - pod.creation_timestamp, 0.0), 3),
            }
            if rows is None:
                if emit:
                    entry["state"] = "unparseable"
                    sample.queue.append(entry)
                continue
            drow, erow, count = rows
            key = shape_key(drow, erow)
            info = sample.headroom.get(key)
            if info is None:
                if emit:
                    entry["shape"] = key
                    entry["gangSize"] = count
                    entry["state"] = "shape-dropped"
                    sample.queue.append(entry)
                continue
            headroom = info["headroom"]
            fits = count <= headroom
            if not fits:
                pressure += 1
            if not emit:
                continue
            entry["shape"] = key
            entry["gangSize"] = count
            entry["fitsNow"] = fits
            entry["headroom"] = headroom
            if self._waste is not None and hasattr(self._waste, "scheduling_info"):
                demand = self._waste.scheduling_info(pod.namespace, pod.name)
                if demand is None or demand.get("demandCreatedAt") is None:
                    entry["demandState"] = "no-demand"
                elif demand.get("demandFulfilledAt") is not None:
                    entry["demandState"] = "demand-fulfilled"
                else:
                    entry["demandState"] = "demand-pending"
            if fits:
                entry["state"] = "admitting-next" if position == 0 else "queued-behind"
                # null, not 0.0, when no admission rate has been
                # observed yet: a queued-behind gang with an unknown
                # wait must not read like admitting-next
                if position == 0:
                    entry["forecastSeconds"] = 0.0
                elif rate > 0:
                    entry["forecastSeconds"] = round(position / rate, 3)
                else:
                    entry["forecastSeconds"] = None
            else:
                entry["state"] = "needs-scaleup"
                entry["forecastSeconds"] = None
            sample.queue.append(entry)
        sample.pressure = pressure

    # -- metrics -------------------------------------------------------------

    def _publish(self, sample: CapacitySample) -> None:
        m = self._metrics
        if m is None:
            return
        m.counter(mnames.CAPACITY_SAMPLE_COUNT, {"trigger": sample.trigger})
        m.histogram(mnames.CAPACITY_SAMPLE_TIME, sample.sample_ms / 1000.0)
        m.histogram(mnames.CAPACITY_PROBE_SOLVES, float(sample.probe_solves))
        for j, dim in enumerate(DIM_NAMES):
            m.gauge(mnames.CAPACITY_FREE, float(sample.free[j]), {"dim": dim})
            m.gauge(mnames.CAPACITY_LARGEST_CHUNK, float(sample.largest_chunk[j]), {"dim": dim})
            m.gauge(mnames.CAPACITY_FRAGMENTATION, float(sample.frag_index[j]), {"dim": dim})
        headroom_tags = []
        for key, info in sample.headroom.items():
            tags = {"shape": key, mnames.TAG_INSTANCE_GROUP: "", mnames.TAG_ZONE: ""}
            headroom_tags.append(tags)
            m.gauge(mnames.CAPACITY_HEADROOM, float(info["headroom"]), tags)
        for combo, entry in sample.groups.items():
            group, _, zone = combo.partition("|")
            for key, h in entry["headroom"].items():
                tags = {"shape": key, mnames.TAG_INSTANCE_GROUP: group, mnames.TAG_ZONE: zone}
                headroom_tags.append(tags)
                m.gauge(mnames.CAPACITY_HEADROOM, float(h), tags)
        tenant_tags = []
        for group, entry in sample.tenants.items():
            tags = {mnames.TAG_INSTANCE_GROUP: group}
            tenant_tags.append(tags)
            m.gauge(mnames.CAPACITY_UTILIZATION, entry["utilization"], tags)
        # shapes and (group, zone) combos churn with the queue and the
        # fleet: drop the series this sample did NOT publish, so a
        # vanished label combination stops exporting its last stale
        # value and live cardinality stays bounded by the sampler caps
        m.prune_gauges(mnames.CAPACITY_HEADROOM, headroom_tags)
        m.prune_gauges(mnames.CAPACITY_UTILIZATION, tenant_tags)
        if sample.classes:
            # fleet shape diversity: the state-layer class identity when
            # the mirror carries an index, else the analytics grouping
            m.gauge(mnames.CLASSES_COUNT, float(sample.classes.get("indexCount", sample.classes["count"])))
            m.gauge(
                mnames.CLASSES_COMPRESSION_RATIO,
                float(sample.classes.get("indexRatio", sample.classes["ratio"])),
            )
            if "expandMs" in sample.classes:
                m.histogram(mnames.CLASSES_EXPAND_MS, float(sample.classes["expandMs"]))
        m.gauge(mnames.CAPACITY_QUEUED_GANGS, float(sample.queued_gangs))
        m.gauge(mnames.CAPACITY_QUEUE_PRESSURE, float(sample.pressure))
        for entry in sample.queue:
            forecast = entry.get("forecastSeconds")
            if forecast is not None:
                m.histogram(mnames.CAPACITY_TIME_TO_ADMIT, float(forecast))
