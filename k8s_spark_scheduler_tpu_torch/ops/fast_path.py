"""Driver-path fast lane: TensorSnapshot → solver tensors with no
Quantity arithmetic.

Replicates, in vectorized integer math, exactly what the slow path
derives from Quantity metadata:

- the AZ-aware node priority order (nodesorting.go:95-122): zones
  ascending by total (memory, cpu) of *available* resources, nodes by
  (zone priority, memory, cpu, name) — int64 lexsorts, name ties via a
  precomputed rank;
- driver candidates = priority ∩ kube-scheduler's list; executor
  candidates = ready ∧ ¬unschedulable (nodesorting.go:41-64);
- the per-role label-priority stable re-sort
  (nodesorting.go:161-180): configured label values map to ascending
  ranks, any other/missing value sorts last, ties keep the base order —
  a stable integer argsort over precomputed rank arrays;
- the required-node-affinity filter over snapshot label dicts
  (resource.go:292-295).

Only usable when the snapshot is exact; callers fall back to the
Quantity path otherwise.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..state.tensor_snapshot import TensorSnapshot
from .nodesort import LabelPriorityOrder
from .tensorize import INT32_SAFE, ClusterTensor


def _label_ranks(labels_list, order: LabelPriorityOrder) -> np.ndarray:
    """Integer sort keys replicating _label_less_than: configured values
    get their list position, anything else (including a missing label)
    a rank past the end so it sorts last; stability preserves the base
    priority order within equal ranks."""
    value_ranks = {v: i for i, v in enumerate(order.descending_priority_values)}
    big = len(order.descending_priority_values)
    return np.fromiter(
        (value_ranks.get(labels.get(order.name), big) for labels in labels_list),
        dtype=np.int64,
        count=len(labels_list),
    )


def _base_priority_order(
    snap: TensorSnapshot, idx: np.ndarray, avail: np.ndarray
) -> np.ndarray:
    """AZ-aware base node priority over the selected rows
    (nodesorting.go:95-122), shared by the driver and executor fast
    lanes: zones ascending by total (memory, cpu, name) of the selected
    availability; nodes by (zone priority, memory, cpu, name).  Returns
    positions into `idx`."""
    zone_id = snap.zone_id[idx]
    n_zones = len(snap.zone_names)
    zone_mem = np.zeros(n_zones, dtype=np.int64)
    zone_cpu = np.zeros(n_zones, dtype=np.int64)
    np.add.at(zone_mem, zone_id, avail[:, 1])
    np.add.at(zone_cpu, zone_id, avail[:, 0])
    zone_name_rank = np.argsort(np.argsort(np.array(snap.zone_names, dtype=object)))
    zone_order = np.lexsort((zone_name_rank, zone_cpu, zone_mem))
    zone_priority = np.empty(n_zones, dtype=np.int64)
    zone_priority[zone_order] = np.arange(n_zones)

    # snapshot-maintained integer name ranks order exactly like the
    # names; lexsort needs only the ordering, not dense subset ranks
    return np.lexsort(
        (snap.name_rank[idx], avail[:, 0], avail[:, 1], zone_priority[zone_id])
    )


def executor_reschedule_order(
    snap: TensorSnapshot,
    candidate_names: List[str],
    executor_label_priority: Optional[LabelPriorityOrder] = None,
    zone: Optional[str] = None,
) -> Optional[Tuple[List[str], np.ndarray, np.ndarray, np.ndarray]]:
    """Executor priority order + exact availability for the executor
    reschedule path (resource.go:594-663): metadata restricted to the
    kube-scheduler candidate list (optionally one zone for single-AZ
    dynamic allocation), AZ-aware sort keyed on
    avail = allocatable − usage − overhead, executor candidates
    ready ∧ ¬unschedulable, then the label-priority stable re-sort.

    Returns (names_in_order, avail_rows [M,3] int64, overhead_rows
    [M,3] int64, reservation_entry_mask [M] bool) or None when the
    snapshot is inexact.  Zone totals for the AZ sort are computed over
    ALL candidate nodes (including not-ready ones), exactly like the
    slow path's metadata."""
    if not snap.exact:
        return None
    nidx = snap.name_index
    rows = np.fromiter(
        (nidx.get(nm, -1) for nm in candidate_names),
        dtype=np.int64,
        count=len(candidate_names),
    )
    idx = np.unique(rows[rows >= 0])  # dedupe like the slow path's metadata dict
    if zone is not None:
        try:
            zi = snap.zone_names.index(zone)
        except ValueError:
            idx = idx[:0]
        else:
            idx = idx[snap.zone_id[idx] == zi]
    if len(idx) == 0:
        return [], np.zeros((0, 3), np.int64), np.zeros((0, 3), np.int64), np.zeros(0, bool)

    avail = snap.avail[idx]
    order = _base_priority_order(snap, idx, avail)

    exec_ok = snap.ready[idx] & ~snap.unschedulable[idx]
    order = order[exec_ok[order]]
    if executor_label_priority is not None:
        keys = _label_ranks([snap.labels[i] for i in idx], executor_label_priority)
        order = order[np.argsort(keys[order], kind="stable")]

    sel = idx[order]
    return (
        [snap.names[i] for i in sel],
        avail[order],  # == snap.avail[sel] without re-materializing the property
        snap.overhead[sel],
        snap.res_entries[sel],
    )


@dataclass
class _BuildPrep:
    """Avail-independent prework of build_cluster_tensor — everything
    derivable from the node TABLE (names/labels/zones/flags) and the
    request's candidate list, cacheable across Filter requests keyed by
    the snapshot's structure revision (the FIFO hot path rebuilds the
    same structures per request; at 10k nodes this was ~20ms of the
    ~24ms build cost)."""

    idx: np.ndarray            # eligible rows into the snapshot
    names: List[str]
    names_arr: np.ndarray      # object array of names (for permuting)
    is_cand: np.ndarray        # [len(idx)] bool — in the candidate list
    exec_ok_base: np.ndarray   # [len(idx)] bool — ready ∧ ¬unschedulable
    d_keys: Optional[np.ndarray]
    e_keys: Optional[np.ndarray]
    zones: Dict[str, str]      # eligible node → zone name


_PREP_CACHE: OrderedDict = OrderedDict()
_PREP_CACHE_MAX = 32
_prep_lock = threading.Lock()


def _single_in_sig(driver_pod):
    """Hashable signature of the dominant affinity shape (one In
    constraint); None = uncacheable shape."""
    if (
        not driver_pod.node_selector
        and not driver_pod.affinity_terms
        and len(driver_pod.node_affinity) == 1
    ):
        ((key, values),) = driver_pod.node_affinity.items()
        return (key, tuple(sorted(values)))
    return None


def _lp_sig(lp: Optional[LabelPriorityOrder]):
    return None if lp is None else (lp.name, tuple(lp.descending_priority_values))


def _compute_prep(snap, driver_pod, candidate_names, dlp, elp) -> _BuildPrep:
    n = len(snap.names)
    # required node affinity + nodeSelector filter (metadata membership),
    # via the same matcher the slow path uses.  The dominant real-world
    # shape — a single In-constraint on one label (the instance group) —
    # is vectorized; anything else falls back to the general matcher.
    single_in = _single_in_sig(driver_pod)
    if single_in is not None:
        key, values = single_in
        allowed = set(values)
        eligible = np.fromiter(
            (labels.get(key) in allowed for labels in snap.labels),
            dtype=bool,
            count=n,
        )
    else:
        eligible = np.fromiter(
            (driver_pod.matches_labels(labels) for labels in snap.labels),
            dtype=bool,
            count=n,
        )
    idx = np.flatnonzero(eligible)
    if len(idx) == 0:
        idx = np.zeros(0, dtype=np.int64)
    names = [snap.names[i] for i in idx]
    candidate_set = set(candidate_names)
    is_cand = np.fromiter(
        (nm in candidate_set for nm in names), dtype=bool, count=len(names)
    )
    need_labels = dlp is not None or elp is not None
    labels_sel = [snap.labels[i] for i in idx] if need_labels else None
    zone_sel = snap.zone_id[idx]
    return _BuildPrep(
        idx=idx,
        names=names,
        names_arr=np.array(names, dtype=object),
        is_cand=is_cand,
        exec_ok_base=snap.ready[idx] & ~snap.unschedulable[idx],
        d_keys=_label_ranks(labels_sel, dlp) if dlp is not None else None,
        e_keys=_label_ranks(labels_sel, elp) if elp is not None else None,
        zones={
            nm: snap.zone_names[zone_sel[i]] for i, nm in enumerate(names)
        },
    )


def _build_prep(snap, driver_pod, candidate_names, dlp, elp) -> _BuildPrep:
    """The avail-independent prework, cached under its exact key —
    (structure revision, affinity signature, candidate tuple,
    label-priority signatures); an uncacheable affinity shape is
    computed afresh."""
    from ..tracing import add_tag

    aff = _single_in_sig(driver_pod)
    key = None
    if aff is not None and snap.structure_key[0] >= 0:
        key = (
            snap.structure_key,
            aff,
            # the tuple itself, not its hash: a hash collision would
            # silently reuse another request's candidate mask
            tuple(candidate_names),
            _lp_sig(dlp),
            _lp_sig(elp),
        )
        with _prep_lock:
            hit = _PREP_CACHE.get(key)
            if hit is not None:
                _PREP_CACHE.move_to_end(key)
                add_tag("prepCache", "hit")
                return hit
    # a miss at 10k nodes is ~20ms of the request — worth seeing on the
    # span when hunting a latency outlier
    add_tag("prepCache", "miss" if key is not None else "uncacheable")
    prep = _compute_prep(snap, driver_pod, candidate_names, dlp, elp)
    if key is not None:
        with _prep_lock:
            _PREP_CACHE[key] = prep
            while len(_PREP_CACHE) > _PREP_CACHE_MAX:
                _PREP_CACHE.popitem(last=False)
    return prep


def build_cluster_tensor(
    snap: TensorSnapshot,
    driver_pod,
    candidate_names: List[str],
    driver_label_priority: Optional[LabelPriorityOrder] = None,
    executor_label_priority: Optional[LabelPriorityOrder] = None,
) -> Optional[Tuple[ClusterTensor, Dict[str, str]]]:
    """(cluster tensor, node→zone map) or None when the fast path can't
    represent the snapshot exactly."""
    if not snap.exact:
        return None
    n = len(snap.names)
    if n == 0:
        # no eligible nodes: an empty tensor is still valid input
        empty = ClusterTensor(
            node_names=[],
            avail=np.zeros((0, 3), np.int64),
            sched=np.zeros((0, 3), np.int64),
            driver_rank=np.zeros(0, np.int32),
            exec_ok=np.zeros(0, bool),
            zone_id=np.zeros(0, np.int32),
            zone_names=[],
            valid=np.zeros(0, bool),
            exact=True,
        )
        return empty, {}

    prep = _build_prep(
        snap, driver_pod, candidate_names, driver_label_priority,
        executor_label_priority,
    )
    idx = prep.idx
    avail = snap.avail[idx]
    sched = snap.schedulable[idx]
    zone_id = snap.zone_id[idx]

    # AZ-aware base priority (shared with the executor lane)
    order = _base_priority_order(snap, idx, avail)

    # per-role label-priority re-sort on top of the base order
    # (nodesorting.go:161-180).  The array order is the EXECUTOR priority
    # order (the solver packs executors in array order); the driver order
    # lives in driver_rank, so the two roles can be re-sorted
    # independently, exactly like the slow path's two stable sorts.
    perm = order
    if prep.e_keys is not None:
        perm = perm[np.argsort(prep.e_keys[perm], kind="stable")]

    # driver order = BASE order ∩ candidates (never the executor-resorted
    # order), stable-sorted by the driver label rank when configured;
    # ranks are then scattered into final array positions
    cand_base_positions = order[np.flatnonzero(prep.is_cand[order])]
    if prep.d_keys is not None:
        cand_base_positions = cand_base_positions[
            np.argsort(prep.d_keys[cand_base_positions], kind="stable")
        ]
    pos_in_array = np.empty(len(perm), dtype=np.int64)
    pos_in_array[perm] = np.arange(len(perm))
    driver_rank = np.full(len(perm), INT32_SAFE, dtype=np.int64)
    driver_rank[pos_in_array[cand_base_positions]] = np.arange(
        len(cand_base_positions)
    )
    ordered_names = list(prep.names_arr[perm])

    cluster = ClusterTensor(
        node_names=ordered_names,
        avail=avail[perm],
        sched=sched[perm],
        driver_rank=driver_rank.astype(np.int32),
        exec_ok=prep.exec_ok_base[perm],
        zone_id=zone_id[perm].astype(np.int32),
        zone_names=list(snap.zone_names),
        valid=np.ones(len(ordered_names), dtype=bool),
        exact=True,
    )
    return cluster, prep.zones
