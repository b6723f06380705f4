"""Gang-level discrete-event replay engine: one matrix cell = one run;
a copy of the reference package's ``lab/engine.py`` (pure Python, no
torch or numpy: the digest contract below holds across packages too).

The full sim (``sim/runner.py``) drives the REAL extender stack and
costs milliseconds per decision — perfect for chaos fidelity, hopeless
for 10^5–10^6-arrival traces × a 24-cell policy matrix.  The lab engine
is the Firmament-style complement (OSDI '16): it models the cluster at
*gang* granularity — integer per-node free vectors, gang-atomic
admission, policy ordering, EASY backfill, Borg preemption, DRF fair
share, autoscaler fulfillment lag, leader-crash outage windows — on an
isolated :class:`~..sim.workload`-trace replay with its own
:class:`~..sim.clock.VirtualClock` per cell, so whole cluster lifetimes
replay in seconds and cells are embarrassingly parallel across worker
processes.

Determinism contract (the per-cell digest is the acceptance gate):

- single-threaded event loop; ties broken by (time, sequence);
- all resource math in exact integers (millicores / bytes);
- every float that enters the event digest or scorecard derives from
  trace values that the synthesizer already rounded — no libm in the
  replay path, so digests are byte-identical across processes and
  platforms;
- the scorecard is rendered by ``lifecycle/scorecard.py`` — the SAME
  schema (and digest algebra) a live server serves on ``GET /slo`` and
  the full sim writes as ``scorecard.json``.

Policy semantics (deliberately small, stated here so matrix deltas are
interpretable):

- ``fifo``: strict arrival order; head-of-line blocks the queue.
- ``priority-then-fifo``: highest band first, FIFO within a band.
- ``drf``: pick the queued tenant with the lowest weighted dominant
  share (NSDI '11), FIFO within the tenant.
- backfill (EASY, JSSPP '95): when the head cannot fit, reserve its
  start at the earliest instant running-gang completions free enough
  capacity; later gangs may jump ONLY if they fit now and either finish
  by that instant or fit inside the spare capacity it leaves.
- preemption (Borg): a blocked head may evict whole gangs of bands at
  least ``min_band_gap`` below it (lowest band, least work lost first,
  at most ``max_victims``) — victims requeue and their lost runtime is
  the eviction-waste metric.
- leader-crash chaos: an admission outage window — arrivals queue,
  completions land, nothing admits until the window clears.
"""

from __future__ import annotations

import hashlib
import json
import time
from bisect import insort
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..lifecycle.scorecard import build_scorecard, scorecard_digest
from ..lifecycle.slo import SloEngine
from ..sim.clock import VirtualClock
from ..sim.workload import AppSpec

# gang states
_QUEUED, _RUNNING, _DONE, _UNSCHEDULABLE = 0, 1, 2, 3

_DEFAULT_BANDS = {"low": 0, "normal": 1, "high": 2}


_CPU_CACHE: Dict[str, int] = {}
_MEM_CACHE: Dict[str, int] = {}
_MEM_SUFFIX = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3, "Ti": 1024**4}


def _parse_cpu(text: str) -> int:
    """Kubernetes cpu quantity -> millicores (exact integers only).
    Memoized — traces draw from a tiny menu of size strings."""
    cached = _CPU_CACHE.get(text)
    if cached is not None:
        return cached
    s = str(text)
    value = int(s[:-1]) if s.endswith("m") else int(float(s) * 1000)
    _CPU_CACHE[text] = value
    return value


def _parse_mem(text: str) -> int:
    """Kubernetes memory quantity -> bytes.  Memoized."""
    cached = _MEM_CACHE.get(text)
    if cached is not None:
        return cached
    s = str(text)
    value = None
    for suffix, mult in _MEM_SUFFIX.items():
        if s.endswith(suffix):
            value = int(float(s[: -len(suffix)]) * mult)
            break
    if value is None:
        value = int(float(s))
    _MEM_CACHE[text] = value
    return value


class _Gang:
    __slots__ = (
        "app_id",
        "arrival",
        "submit_t",
        "lifetime",
        "band",
        "band_rank",
        "tenant",
        "n_exec",
        "dcpu",
        "dmem",
        "ecpu",
        "emem",
        "cpu",
        "mem",
        "state",
        "start_t",
        "placements",
        "evictions",
        "seq",
    )

    def __init__(self, spec: AppSpec, bands: Dict[str, int], seq: int):
        self.app_id = spec.app_id
        self.arrival = spec.arrival
        self.submit_t = spec.arrival
        self.lifetime = spec.lifetime
        self.band = spec.band
        self.band_rank = bands.get(spec.band, bands.get("normal", 1))
        self.tenant = spec.tenant
        # gang-atomic demand: driver + (min executors for dynamic
        # allocation, full count for static) — DA extras are soft
        self.n_exec = spec.min_executor_count if spec.dynamic else spec.executor_count
        self.n_exec = max(1, int(self.n_exec))
        self.dcpu = _parse_cpu(spec.driver_cpu)
        self.dmem = _parse_mem(spec.driver_mem)
        self.ecpu = _parse_cpu(spec.executor_cpu)
        self.emem = _parse_mem(spec.executor_mem)
        self.cpu = self.dcpu + self.n_exec * self.ecpu
        self.mem = self.dmem + self.n_exec * self.emem
        self.state = _QUEUED
        self.start_t = 0.0
        self.placements: List[Tuple[int, int, int]] = []
        self.evictions = 0
        self.seq = seq


def compute_cell_digest(
    scorecard_digest_value: str, events_digest: str, kpis: Dict
) -> str:
    """The canonical per-cell digest.  Exposed so the matrix gate can
    RECOMPUTE it from a cell document instead of trusting the stored
    value — a forged baseline digest cannot mask a drift."""
    body = {
        "scorecard": scorecard_digest_value,
        "events": events_digest,
        "kpis": kpis,
    }
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


class CellResult:
    """Everything one cell produces: the scorecard, flat KPIs,
    counters, and the deterministic digests the matrix gate compares."""

    def __init__(
        self,
        cell_id: str,
        axes: Dict,
        scorecard: Dict,
        kpis: Dict,
        counters: Dict,
        events_digest: str,
        events: int,
        wall_s: float,
    ):
        self.cell_id = cell_id
        self.axes = axes
        self.scorecard = scorecard
        self.kpis = kpis
        self.counters = counters
        self.events_digest = events_digest
        self.events = events
        self.wall_s = wall_s
        self.digest = compute_cell_digest(
            scorecard["digest"], events_digest, kpis
        )

    def to_dict(self) -> Dict:
        return {
            "cell": self.cell_id,
            "axes": self.axes,
            "digest": self.digest,
            "eventsDigest": self.events_digest,
            "events": self.events,
            "wallSeconds": round(self.wall_s, 3),
            "kpis": self.kpis,
            "counters": self.counters,
            "scorecard": self.scorecard,
        }


class _LedgerView:
    """Adapter handing ``build_scorecard`` a ledger-shaped summary —
    same leaves as ``LifecycleLedger.summary()`` so the scorecard
    schema (and its digest algebra) never forks on source."""

    def __init__(self, summary: Dict):
        self._summary = summary

    def summary(self) -> Dict:
        return self._summary


class GangLabSim:
    """One cell: replay ``apps`` under one policy configuration.

    ``cfg`` keys (all optional; the spec layer fills them):
    ``ordering``, ``preemption``, ``backfill``, ``drf_weights``,
    ``autoscaler_lag``, ``chaos``, ``nodes``, ``node_cpu``,
    ``node_memory``, ``horizon``, ``bands``, ``min_band_gap``,
    ``max_victims``, ``backfill_depth``, ``window_scale``,
    ``max_extra_nodes``.
    """

    def __init__(self, apps: List[AppSpec], cfg: Dict):
        self.cfg = dict(cfg)
        self.ordering = cfg.get("ordering", "fifo")
        self.preemption = bool(cfg.get("preemption", False))
        self.backfill = bool(cfg.get("backfill", False))
        self.backfill_depth = int(cfg.get("backfill_depth", 32))
        self.min_band_gap = int(cfg.get("min_band_gap", 1))
        self.max_victims = int(cfg.get("max_victims", 4))
        self.bands = dict(cfg.get("bands", _DEFAULT_BANDS))
        self.drf_weights = dict(cfg.get("drf_weights") or {})
        lag = cfg.get("autoscaler_lag")
        self.autoscaler_lag = None if lag is None else float(lag)
        self.chaos = cfg.get("chaos") or None
        self.horizon = float(cfg.get("horizon", 0.0)) or (
            (apps[-1].arrival if apps else 0.0) + 3600.0
        )
        self.node_cpu = _parse_cpu(cfg.get("node_cpu", "16"))
        self.node_mem = _parse_mem(cfg.get("node_memory", "64Gi"))
        n_nodes = int(cfg.get("nodes", 16))
        self.ncpu = [self.node_cpu] * n_nodes
        self.nmem = [self.node_mem] * n_nodes
        self.cap_cpu = self.node_cpu * n_nodes
        self.cap_mem = self.node_mem * n_nodes
        self.free_cpu = self.cap_cpu
        self.free_mem = self.cap_mem
        self.max_extra_nodes = int(cfg.get("max_extra_nodes", n_nodes))

        self.clock = VirtualClock(start=0.0)
        self.apps = apps
        self._gangs: List[_Gang] = []
        self._seq = 0

        # queues: fifo -> one deque; priority -> per-band; drf -> per-tenant
        self._fifo: deque = deque()
        self._by_band: Dict[int, deque] = {}
        self._by_tenant: Dict[str, deque] = {}
        # running accounting
        self._running: Dict[str, _Gang] = {}
        self._band_running: Dict[int, List[int]] = {}  # rank -> [cpu, mem]
        self._tenant_running: Dict[str, List[int]] = {}
        # sorted future completions: (end_t, seq, cpu, mem)
        self._completions: List[Tuple[float, int, int, int]] = []
        # EASY shadow reservation for the blocked head
        self._shadow_head: Optional[str] = None
        self._shadow_until = 0.0
        self._shadow_spare = (0, 0)
        # autoscaler orders: (fulfill_t, n_nodes); extra nodes added so far
        self._orders_outstanding = 0
        self._nodes_added = 0
        self._chaos_active = False
        self._chaos_started = 0.0

        # metrics
        self._waits: List[float] = []
        self._waste: List[float] = []
        self._fair_gaps: List[float] = []
        # incremental event digest: hashing newline-terminated lines as
        # they happen instead of storing 10^5+ strings for a final join
        self._events_hash = hashlib.sha256()
        self._events_count = 0
        self._last_t = 0.0
        self._util_cpu = 0.0
        self._util_mem = 0.0
        self._cap_cpu_integral = 0.0
        self._cap_mem_integral = 0.0
        self.counters = {
            "arrived": 0,
            "admissions": 0,
            "completed": 0,
            "evictions": 0,
            "preemptions": 0,
            "backfill_admits": 0,
            "backfill_skips": 0,
            "unschedulable": 0,
            "scaleup_orders": 0,
            "nodes_added": 0,
            "chaos_windows": 0,
            "gangs_spanning_chaos": 0,
            "passes": 0,
        }
        self.slo = SloEngine(
            window_scale=float(cfg.get("window_scale", 1.0)),
            overrides=cfg.get("slo_overrides"),
        )

    # -- event loop -----------------------------------------------------------

    def run(self) -> CellResult:
        wall0 = time.perf_counter()
        clock = self.clock
        if self.chaos is not None:
            at = float(self.chaos.get("at", self.horizon / 2))
            duration = float(self.chaos.get("duration", 300.0))
            every = self.chaos.get("every")
            while at < self.horizon:
                clock.schedule(at, "chaos-on", self._chaos_on)
                clock.schedule(at + duration, "chaos-off", self._chaos_off)
                if not every:
                    break
                at += float(every)
        apps = self.apps
        i, n = 0, len(apps)
        while True:
            t_ev = clock.peek_time()
            t_arr = apps[i].arrival if i < n else None
            if t_arr is None and t_ev is None:
                break
            # arrivals win ties: a gang submitted at instant T is
            # visible to every other event at T (deterministic order)
            if t_arr is not None and (t_ev is None or t_arr <= t_ev):
                if t_arr > self.horizon:
                    break
                self._advance(t_arr)
                self._on_arrival(apps[i])
                i += 1
                continue
            if t_ev > self.horizon:
                break
            clock.run_next()
        self._advance(self.horizon)
        wall_s = time.perf_counter() - wall0
        return self._result(wall_s)

    def _advance(self, t: float) -> None:
        """Move utilization integrals forward to ``t`` (clock time is
        advanced by the VirtualClock itself when events pop)."""
        dt = t - self._last_t
        if dt > 0:
            used_cpu = self.cap_cpu - self.free_cpu
            used_mem = self.cap_mem - self.free_mem
            self._util_cpu += used_cpu * dt
            self._util_mem += used_mem * dt
            self._cap_cpu_integral += self.cap_cpu * dt
            self._cap_mem_integral += self.cap_mem * dt
            self._last_t = t
        self.clock.advance_to(t)

    def _event(self, line: str) -> None:
        self._events_hash.update(line.encode())
        self._events_hash.update(b"\n")
        self._events_count += 1

    # -- event handlers -------------------------------------------------------

    def _on_arrival(self, spec: AppSpec) -> None:
        gang = _Gang(spec, self.bands, self._seq)
        self._seq += 1
        self._gangs.append(gang)
        self.counters["arrived"] += 1
        self._enqueue(gang)
        self._event(f"{spec.arrival:.3f} arr {spec.app_id}")
        self._pass(spec.arrival)

    def _on_complete(self, gang: _Gang, end_t: float) -> None:
        if gang.state != _RUNNING:
            return  # evicted before its completion event fired
        self._advance(end_t)
        self._release(gang, end_t)
        gang.state = _DONE
        self.counters["completed"] += 1
        self._event(f"{end_t:.3f} done {gang.app_id}")
        self._pass(end_t)

    def _chaos_on(self) -> None:
        now = self.clock.now()
        self._advance(now)
        self._chaos_active = True
        self._chaos_started = now
        self.counters["chaos_windows"] += 1
        self._event(f"{now:.3f} chaos-on")

    def _chaos_off(self) -> None:
        now = self.clock.now()
        self._advance(now)
        self._chaos_active = False
        spanning = sum(
            1 for g in self._running.values() if g.start_t < self._chaos_started
        )
        self.counters["gangs_spanning_chaos"] += spanning
        self._event(f"{now:.3f} chaos-off {spanning}")
        self._pass(now)

    def _on_scaleup(self, count: int) -> None:
        now = self.clock.now()
        self._advance(now)
        self._orders_outstanding -= count
        for _ in range(count):
            self.ncpu.append(self.node_cpu)
            self.nmem.append(self.node_mem)
        add_cpu = count * self.node_cpu
        add_mem = count * self.node_mem
        self.cap_cpu += add_cpu
        self.cap_mem += add_mem
        self.free_cpu += add_cpu
        self.free_mem += add_mem
        self._nodes_added += count
        self.counters["nodes_added"] += count
        self._event(f"{now:.3f} scale-up {count}")
        self._pass(now)

    # -- queues ---------------------------------------------------------------

    def _enqueue(self, gang: _Gang) -> None:
        if self.ordering == "priority-then-fifo":
            self._by_band.setdefault(gang.band_rank, deque()).append(gang)
        elif self.ordering == "drf":
            self._by_tenant.setdefault(gang.tenant, deque()).append(gang)
        else:
            self._fifo.append(gang)

    def _peek_head(self) -> Optional[_Gang]:
        if self.ordering == "priority-then-fifo":
            for rank in sorted(self._by_band, reverse=True):
                q = self._by_band[rank]
                while q and q[0].state != _QUEUED:
                    q.popleft()
                if q:
                    return q[0]
            return None
        if self.ordering == "drf":
            best, best_key = None, None
            for tenant in sorted(self._by_tenant):
                q = self._by_tenant[tenant]
                while q and q[0].state != _QUEUED:
                    q.popleft()
                if not q:
                    continue
                key = (self._dominant_share(tenant), tenant)
                if best_key is None or key < best_key:
                    best, best_key = q[0], key
            return best
        q = self._fifo
        while q and q[0].state != _QUEUED:
            q.popleft()
        return q[0] if q else None

    def _backfill_candidates(self, head: _Gang):
        """Up to ``backfill_depth`` queued gangs after the head, in
        policy order (generator; skips tombstoned entries)."""
        depth = self.backfill_depth
        yielded = 0
        if self.ordering == "priority-then-fifo":
            for rank in sorted(self._by_band, reverse=True):
                for g in self._by_band[rank]:
                    if g.state != _QUEUED or g is head:
                        continue
                    yield g
                    yielded += 1
                    if yielded >= depth:
                        return
        elif self.ordering == "drf":
            tenants = sorted(
                self._by_tenant, key=lambda t: (self._dominant_share(t), t)
            )
            for tenant in tenants:
                for g in self._by_tenant[tenant]:
                    if g.state != _QUEUED or g is head:
                        continue
                    yield g
                    yielded += 1
                    if yielded >= depth:
                        return
        else:
            for g in self._fifo:
                if g.state != _QUEUED or g is head:
                    continue
                yield g
                yielded += 1
                if yielded >= depth:
                    return

    def _dominant_share(self, tenant: str) -> float:
        usage = self._tenant_running.get(tenant)
        if usage is None or self.cap_cpu == 0:
            return 0.0
        share = max(usage[0] / self.cap_cpu, usage[1] / self.cap_mem)
        weight = self.drf_weights.get(tenant, 1.0)
        return share / weight if weight > 0 else share

    # -- admission ------------------------------------------------------------

    def _pass(self, now: float) -> None:
        """One scheduling pass: admit in policy order until the head
        blocks, then try preemption, autoscaling, and EASY backfill."""
        if self._chaos_active:
            return
        self.counters["passes"] += 1
        while True:
            head = self._peek_head()
            if head is None:
                return
            if self._try_admit(head, now):
                head.state = _RUNNING  # tombstone in whichever deque holds it
                continue
            # head is blocked
            if head.cpu > self.cap_cpu or head.mem > self.cap_mem:
                if self.autoscaler_lag is None or not self._order_nodes(head, now):
                    # can never fit (and autoscaling is off or capped)
                    head.state = _UNSCHEDULABLE
                    self.counters["unschedulable"] += 1
                    self._event(f"{now:.3f} unsched {head.app_id}")
                    continue
                break
            if self.preemption and self._try_preempt(head, now):
                if self._try_admit(head, now):
                    head.state = _RUNNING
                    continue
            if self.autoscaler_lag is not None:
                self._order_nodes(head, now)
            if self.backfill:
                self._run_backfill(head, now)
            return

    def _try_admit(self, gang: _Gang, now: float) -> bool:
        if gang.cpu > self.free_cpu or gang.mem > self.free_mem:
            return False
        placements = self._binpack(gang)
        if placements is None:
            return False
        self._commit(gang, placements, now)
        return True

    def _binpack(self, gang: _Gang) -> Optional[List[Tuple[int, int, int]]]:
        """First-fit the driver, then greedily fill executors node by
        node.  Returns committed-per-node (idx, cpu, mem) amounts, or
        None when fragmentation defeats the gang despite aggregate fit."""
        ncpu, nmem = self.ncpu, self.nmem
        dcpu, dmem = gang.dcpu, gang.dmem
        ecpu, emem = gang.ecpu, gang.emem
        remaining = gang.n_exec
        placements: List[Tuple[int, int, int]] = []
        driver_idx = -1
        for i in range(len(ncpu)):
            fc, fm = ncpu[i], nmem[i]
            take_cpu = 0
            take_mem = 0
            if driver_idx < 0 and fc >= dcpu and fm >= dmem:
                driver_idx = i
                take_cpu, take_mem = dcpu, dmem
                fc -= dcpu
                fm -= dmem
            if remaining > 0:
                k = min(remaining, fc // ecpu, fm // emem)
                if k > 0:
                    take_cpu += k * ecpu
                    take_mem += k * emem
                    remaining -= k
            if take_cpu or take_mem:
                placements.append((i, take_cpu, take_mem))
            if driver_idx >= 0 and remaining == 0:
                return placements
        return None

    def _commit(self, gang: _Gang, placements: List[Tuple[int, int, int]], now: float) -> None:
        ncpu, nmem = self.ncpu, self.nmem
        for i, c, m in placements:
            ncpu[i] -= c
            nmem[i] -= m
        self.free_cpu -= gang.cpu
        self.free_mem -= gang.mem
        gang.placements = placements
        gang.state = _RUNNING
        gang.start_t = now
        end_t = round(now + gang.lifetime, 3)
        self._running[gang.app_id] = gang
        band = self._band_running.setdefault(gang.band_rank, [0, 0])
        band[0] += gang.cpu
        band[1] += gang.mem
        tenant = self._tenant_running.setdefault(gang.tenant, [0, 0])
        tenant[0] += gang.cpu
        tenant[1] += gang.mem
        insort(self._completions, (end_t, gang.seq, gang.cpu, gang.mem))
        self.clock.schedule(end_t, "done", lambda g=gang, t=end_t: self._on_complete(g, t))
        wait = round(now - gang.submit_t, 3)
        self._waits.append(wait)
        self.slo.observe("time_to_admit", wait, t=now)
        self.counters["admissions"] += 1
        self._event(f"{now:.3f} admit {gang.app_id} w={wait:.3f}")
        if self._shadow_head == gang.app_id:
            self._shadow_head = None
        if len(self._tenant_running) >= 2:
            shares = [
                self._dominant_share(t) for t in sorted(self._tenant_running)
            ]
            self._fair_gaps.append(max(shares) - min(shares))
            self.slo.observe("fairness_gap", self._fair_gaps[-1], t=now)

    def _release(self, gang: _Gang, now: float) -> None:
        ncpu, nmem = self.ncpu, self.nmem
        for i, c, m in gang.placements:
            ncpu[i] += c
            nmem[i] += m
        self.free_cpu += gang.cpu
        self.free_mem += gang.mem
        gang.placements = []
        self._running.pop(gang.app_id, None)
        band = self._band_running.get(gang.band_rank)
        if band is not None:
            band[0] -= gang.cpu
            band[1] -= gang.mem
        tenant = self._tenant_running.get(gang.tenant)
        if tenant is not None:
            tenant[0] -= gang.cpu
            tenant[1] -= gang.mem
        # remove the scheduled completion entry (evictions cancel it)
        end_t = round(gang.start_t + gang.lifetime, 3)
        entry = (end_t, gang.seq, gang.cpu, gang.mem)
        from bisect import bisect_left

        idx = bisect_left(self._completions, entry)
        if idx < len(self._completions) and self._completions[idx] == entry:
            self._completions.pop(idx)

    # -- preemption (Borg) ----------------------------------------------------

    def _try_preempt(self, head: _Gang, now: float) -> bool:
        """Evict whole low-band gangs to make room for the head; only
        commits when a sufficient victim set exists within max_victims."""
        limit_rank = head.band_rank - self.min_band_gap
        if limit_rank < 0:
            return False
        evictable_cpu = evictable_mem = 0
        for rank, totals in self._band_running.items():
            if rank <= limit_rank:
                evictable_cpu += totals[0]
                evictable_mem += totals[1]
        if (
            self.free_cpu + evictable_cpu < head.cpu
            or self.free_mem + evictable_mem < head.mem
        ):
            return False
        candidates = [
            g for g in self._running.values() if g.band_rank <= limit_rank
        ]
        # lowest band first, least work lost first (Borg's waste-min)
        candidates.sort(key=lambda g: (g.band_rank, -g.start_t, g.app_id))
        victims: List[_Gang] = []
        acc_cpu = acc_mem = 0
        for g in candidates:
            if len(victims) >= self.max_victims:
                break
            victims.append(g)
            acc_cpu += g.cpu
            acc_mem += g.mem
            if (
                self.free_cpu + acc_cpu >= head.cpu
                and self.free_mem + acc_mem >= head.mem
            ):
                break
        if (
            self.free_cpu + acc_cpu < head.cpu
            or self.free_mem + acc_mem < head.mem
        ):
            return False
        for g in victims:
            self._evict(g, now)
        self.counters["preemptions"] += 1
        return True

    def _evict(self, gang: _Gang, now: float) -> None:
        self._release(gang, now)
        waste = round(now - gang.start_t, 3)
        self._waste.append(waste)
        self.slo.observe("eviction_waste", waste, t=now)
        gang.state = _QUEUED
        gang.submit_t = now
        gang.evictions += 1
        self.counters["evictions"] += 1
        self._enqueue(gang)
        self._event(f"{now:.3f} evict {gang.app_id} waste={waste:.3f}")

    # -- autoscaler -----------------------------------------------------------

    def _order_nodes(self, head: _Gang, now: float) -> bool:
        budget = self.max_extra_nodes - self._nodes_added - self._orders_outstanding
        if budget <= 0:
            return False
        deficit_cpu = head.cpu - self.free_cpu
        deficit_mem = head.mem - self.free_mem
        pending = self._orders_outstanding * self.node_cpu
        pending_mem = self._orders_outstanding * self.node_mem
        deficit_cpu -= pending
        deficit_mem -= pending_mem
        if deficit_cpu <= 0 and deficit_mem <= 0:
            return True  # already on order
        need = max(
            -(-deficit_cpu // self.node_cpu) if deficit_cpu > 0 else 0,
            -(-deficit_mem // self.node_mem) if deficit_mem > 0 else 0,
        )
        count = int(min(need, budget))
        if count <= 0:
            return False
        self._orders_outstanding += count
        self.counters["scaleup_orders"] += 1
        self.clock.schedule(
            now + self.autoscaler_lag,
            "scale-up",
            lambda c=count: self._on_scaleup(c),
        )
        return True

    # -- EASY backfill --------------------------------------------------------

    def _head_reservation(self, head: _Gang, now: float) -> Tuple[float, int, int]:
        """Shadow-reserve the blocked head: walk future completions
        (and pending scale-ups) until enough frees, returning the
        promised start instant and the spare capacity beyond the head's
        demand at that instant."""
        acc_cpu, acc_mem = self.free_cpu, self.free_mem
        events: List[Tuple[float, int, int]] = [
            (t, c, m) for t, _, c, m in self._completions
        ]
        t_start = float("inf")
        for t, c, m in events:
            acc_cpu += c
            acc_mem += m
            if acc_cpu >= head.cpu and acc_mem >= head.mem:
                t_start = t
                break
        del now
        return t_start, max(0, acc_cpu - head.cpu), max(0, acc_mem - head.mem)

    def _run_backfill(self, head: _Gang, now: float) -> None:
        if self._shadow_head != head.app_id:
            t_start, spare_cpu, spare_mem = self._head_reservation(head, now)
            self._shadow_head = head.app_id
            self._shadow_until = t_start
            self._shadow_spare = (spare_cpu, spare_mem)
        t_start = self._shadow_until
        spare_cpu, spare_mem = self._shadow_spare
        for g in list(self._backfill_candidates(head)):
            fits_by_time = now + g.lifetime <= t_start
            fits_in_spare = g.cpu <= spare_cpu and g.mem <= spare_mem
            if not (fits_by_time or fits_in_spare):
                self.counters["backfill_skips"] += 1
                continue
            if not self._try_admit(g, now):
                continue
            g.state = _RUNNING
            self.counters["backfill_admits"] += 1
            if not fits_by_time:
                spare_cpu -= g.cpu
                spare_mem -= g.mem
        self._shadow_spare = (spare_cpu, spare_mem)

    # -- results --------------------------------------------------------------

    def _lifecycle_summary(self) -> Dict:
        phases: Dict[str, int] = {}
        queued = running = completed = expired = 0
        for g in self._gangs:
            if g.state == _QUEUED:
                queued += 1
            elif g.state == _RUNNING:
                running += 1
            elif g.state == _DONE:
                completed += 1
            else:
                expired += 1
        if queued:
            phases["queued"] = queued
        if running:
            phases["running"] = running
        if completed:
            phases["completed"] = completed
        if expired:
            phases["expired"] = expired
        waits = sorted(self._waits)
        c = self.counters
        transitions = c["arrived"] + c["admissions"] + c["completed"] + c["evictions"]
        out: Dict = {
            "gangs": len(self._gangs),
            "phases": phases,
            "transitions": transitions,
            "queueWait": {
                "count": len(waits),
                "p50": _pct(waits, 0.50),
                "p95": _pct(waits, 0.95),
                "p99": _pct(waits, 0.99),
            },
            "evictionsByCause": (
                {"preempted": c["evictions"]} if c["evictions"] else {}
            ),
            "epochContinuity": {
                "gangsSpanningEpochs": c["gangs_spanning_chaos"],
                "epochRegressions": 0,
            },
            # operational counters (excluded from the scorecard digest,
            # same as the live ledger's drain-loop cadence)
            "drains": c["passes"],
            "lockViolations": 0,
        }
        return out

    def _kpis(self) -> Dict:
        waits = sorted(self._waits)
        waste_total = round(sum(self._waste), 3)
        gaps = sorted(self._fair_gaps)
        c = self.counters
        util_cpu = (
            self._util_cpu / self._cap_cpu_integral if self._cap_cpu_integral else 0.0
        )
        util_mem = (
            self._util_mem / self._cap_mem_integral if self._cap_mem_integral else 0.0
        )
        return {
            "packing_efficiency": {
                "cpu": round(util_cpu, 6),
                "memory": round(util_mem, 6),
                "max": round(max(util_cpu, util_mem), 6),
            },
            "wait_seconds": {
                "count": len(waits),
                "mean": round(sum(waits) / len(waits), 3) if waits else 0.0,
                "p50": _pct(waits, 0.50) or 0.0,
                "p95": _pct(waits, 0.95) or 0.0,
                "p99": _pct(waits, 0.99) or 0.0,
            },
            "eviction_waste_seconds": {
                "total": waste_total,
                "events": c["evictions"],
                "mean": round(waste_total / c["evictions"], 3) if c["evictions"] else 0.0,
            },
            "fairness_gap": {
                "samples": len(gaps),
                "p95": round(_pct(gaps, 0.95) or 0.0, 6),
                "max": round(gaps[-1], 6) if gaps else 0.0,
            },
            "throughput": {
                "arrived": c["arrived"],
                "admitted": c["admissions"],
                "completed": c["completed"],
                "pending_at_end": sum(1 for g in self._gangs if g.state == _QUEUED),
                "unschedulable": c["unschedulable"],
            },
        }

    def _result(self, wall_s: float) -> CellResult:
        self.slo.evaluate(now=self.horizon)
        summary = self._lifecycle_summary()
        cell_id = self.cfg.get("cell_id", "cell")
        scorecard = build_scorecard(
            _LedgerView(summary),
            self.slo,
            meta={
                "source": "lab",
                "cell": cell_id,
                "seed": self.cfg.get("seed", 0),
                "trace": self.cfg.get("trace_digest", ""),
                "arrivals": len(self.apps),
            },
            now=self.horizon,
        )
        events_digest = self._events_hash.hexdigest()
        axes = {
            "ordering": self.ordering,
            "preemption": self.preemption,
            "backfill": self.backfill,
            "drf_weights": self.drf_weights,
            "autoscaler_lag": self.autoscaler_lag,
            "chaos": bool(self.chaos),
        }
        return CellResult(
            cell_id=cell_id,
            axes=axes,
            scorecard=scorecard,
            kpis=self._kpis(),
            counters=dict(self.counters),
            events_digest=events_digest,
            events=self._events_count,
            wall_s=wall_s,
        )


def run_cell(apps: List[AppSpec], cfg: Dict) -> CellResult:
    """Convenience wrapper: one isolated cell run."""
    return GangLabSim(apps, cfg).run()


def _pct(sorted_values: List[float], q: float) -> Optional[float]:
    if not sorted_values:
        return None
    idx = min(
        len(sorted_values) - 1, max(0, int(q * len(sorted_values) + 0.5) - 1)
    )
    return round(sorted_values[idx], 6)


# sanity check at import: the scorecard digest algebra must be the
# shared one — a fork here would silently decouple the matrix gate from
# the live /slo contract
assert scorecard_digest is not None
