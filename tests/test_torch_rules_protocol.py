"""The port's PC protocol rules: the reference's broken-twin fixtures
(tests/fixtures/protocol/, shared) caught at the same pinned file:line
by the port's analyzer, the fixed twins clean, and the runtime
regressions for the reference's three true positives run against the
port's components (the port's tree is held clean statically by
tests/test_torch_analysis.py).
"""

import os

import pytest

from k8s_spark_scheduler_tpu_torch.analysis import AnalysisConfig, analyze_paths
from k8s_spark_scheduler_tpu_torch.concurrent.engine import ConcurrentAdmissionEngine
from k8s_spark_scheduler_tpu_torch.config import ConcurrentConfig
from k8s_spark_scheduler_tpu_torch.ha.fencing import (
    FencedWriter,
    FenceState,
    StaleEpochError,
)
from k8s_spark_scheduler_tpu_torch.metrics.registry import MetricsRegistry
from k8s_spark_scheduler_tpu_torch.policy.preempt import EVICT_KIND, PreemptionCoordinator

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "protocol")


def _analyze_fixture(name):
    path = os.path.join(FIXTURES, name)
    config = AnalysisConfig(select=("PC",), use_default_allowlist=False)
    return analyze_paths([path], config=config, root=FIXTURES)


def _analyze_snippet(tmp_path, source):
    f = tmp_path / "snippet.py"
    f.write_text(source)
    config = AnalysisConfig(select=("PC",), use_default_allowlist=False)
    return analyze_paths([str(f)], config=config, root=str(tmp_path))


# -- the seeded broken twins, pinned file:line --------------------------------


def test_pc001_catches_ticket_leak_twin():
    findings = _analyze_fixture("broken_ticket_leak.py")
    assert [(f.rule, f.file, f.line, f.symbol) for f in findings] == [
        ("PC001", "broken_ticket_leak.py", 8, "BrokenPredicate.predicate"),
    ]
    assert "exception path" in findings[0].message


def test_pc002_catches_double_retire_twin():
    findings = _analyze_fixture("broken_double_retire.py")
    assert [(f.rule, f.file, f.line, f.symbol) for f in findings] == [
        ("PC002", "broken_double_retire.py", 15, "BrokenRequest.request"),
    ]
    assert "already be retired" in findings[0].message


def test_pc003_catches_unfenced_write_twin():
    findings = _analyze_fixture("broken_unfenced_write.py")
    assert [(f.rule, f.file, f.line, f.symbol) for f in findings] == [
        ("PC003", "broken_unfenced_write.py", 16, "BrokenCoordinator._execute"),
    ]
    # the message names the unfenced *path*, not just the write
    assert "BrokenCoordinator.recover" in findings[0].message
    assert "BrokenCoordinator._execute" in findings[0].message


def test_pc004_catches_journal_ack_twin():
    findings = _analyze_fixture("broken_journal_ack.py")
    assert [(f.rule, f.file, f.line, f.symbol) for f in findings] == [
        ("PC004", "broken_journal_ack.py", 13, "BrokenWorker.run_one"),
    ]


def test_pc005_catches_span_and_lock_leak_twin():
    findings = _analyze_fixture("broken_span_leak.py")
    assert [(f.rule, f.file, f.line, f.symbol) for f in findings] == [
        ("PC005", "broken_span_leak.py", 8, "BrokenHandler.handle"),
        ("PC005", "broken_span_leak.py", 8, "BrokenHandler.handle"),
        ("PC005", "broken_span_leak.py", 16, "BrokenHandler.try_lock"),
    ]
    msgs = " | ".join(f.message for f in findings[:2])
    assert "a fall-through path" in msgs and "an exception path" in msgs


def test_pc006_catches_phase_skip_twin():
    findings = _analyze_fixture("broken_phase_skip.py")
    assert [(f.rule, f.file, f.line, f.symbol) for f in findings] == [
        ("PC006", "broken_phase_skip.py", 12, "BrokenExtender.select"),
    ]
    assert "binpack" in findings[0].message


# -- the fixed shapes stay clean ----------------------------------------------


FIXED_PREDICATE = """\
class Engine:
    def predicate(self, args):
        ticket = self.gate.ticket()
        committed = False
        try:
            verdict = self.speculator.speculate(ticket, args)
            result = self.commit(args, verdict)
            committed = True
            return result
        finally:
            try:
                self.speculator.finish(ticket)
            finally:
                self.gate.retire(ticket, committed)
"""

FIXED_REQUEST = """\
class Request:
    def request(self, st, abort):
        ticket = st.gate.ticket()
        committed = False
        try:
            if abort:
                return
            st.gate.await_turn(ticket)
            committed = True
        finally:
            st.gate.retire(ticket, committed)
"""

FIXED_RECOVER = """\
# schedlint: entrypoints=Coordinator.recover
class Coordinator:
    def _execute(self, ns, app_id):
        self._api.delete("Pod", ns, app_id)

    def recover(self):
        gate = self.fence_gate
        if gate is not None:
            gate.check("preempt.recover")
        for intent in self._journal.pending():
            self._execute(intent["ns"], intent["name"])
"""

FIXED_WORKER = """\
class Worker:
    def run_one(self, r):
        self._journal.record("create", r.kind, r.ns, r.name, r.obj)
        self._client.create(r.kind, r.ns, r.obj)
        self._journal.ack("create", r.ns, r.name)
"""

FIXED_HANDLER = """\
class Handler:
    def handle(self, req):
        span = self._tracer.span("request")
        span.__enter__()
        try:
            if req.bad:
                return None
            return self._process(req)
        finally:
            span.__exit__(None, None, None)
"""

FIXED_PHASES = """\
class Extender:
    def select(self, ctx):
        self._check_deadline("fifo-gate")
        fitted = self._try_device_fifo(ctx)
        if fitted is None:
            fitted = self._fit_earlier_drivers(ctx)
        self._check_deadline("binpack")
        with self._tracer.span("binpack"):
            plan = self.binpacker.binpack(ctx)
        self._check_deadline("reservation-writeback")
        self._rrm.create_reservations(plan)
        return plan
"""


@pytest.mark.parametrize(
    "source",
    [
        FIXED_PREDICATE,
        FIXED_REQUEST,
        FIXED_RECOVER,
        FIXED_WORKER,
        FIXED_HANDLER,
        FIXED_PHASES,
    ],
    ids=["predicate", "request", "recover", "worker", "handler", "phases"],
)
def test_fixed_twin_is_clean(tmp_path, source):
    assert _analyze_snippet(tmp_path, source) == []


# -- PC004: exits in the recorded state are "left pending", not findings ------


LEFT_PENDING = """\
class Worker:
    def run_one(self, r):
        self._journal.record("create", r.kind, r.ns, r.name, r.obj)
        self._client.create(r.kind, r.ns, r.obj)
"""


def test_pc004_allows_intent_left_pending(tmp_path):
    # a crash between record and ack leaves the intent for replay —
    # that IS the journal contract, not a violation
    assert _analyze_snippet(tmp_path, LEFT_PENDING) == []


MOOT_ACK = """\
class Worker:
    def replay(self, intents):
        for it in intents:
            self._journal.ack("create", it.ns, it.name)
"""


def test_pc004_allows_moot_acks_in_replay(tmp_path):
    # replay paths ack intents whose op already landed; no record in
    # scope means nothing can be lost
    assert _analyze_snippet(tmp_path, MOOT_ACK) == []


# -- runtime regressions for the real findings --------------------------------


class _StubExtender:
    def predicate(self, args):
        return {"ok": True, "args": args}

    def _fail_with_message(self, kind, args, msg):  # pragma: no cover
        return {"ok": False, "msg": msg}


def _engine():
    return ConcurrentAdmissionEngine(
        _StubExtender(),
        ConcurrentConfig(enabled=True, speculation=False),
        metrics=MetricsRegistry(),
    )


def test_predicate_retires_ticket_even_when_finish_raises():
    """The PC001 finding made real: `speculator.finish` raising inside
    the finally must not skip the retire — a skipped retire stalls the
    FIFO head forever."""
    engine = _engine()

    def exploding_finish(ticket):
        raise RuntimeError("finish blew up")

    engine.speculator.finish = exploding_finish
    with pytest.raises(RuntimeError, match="finish blew up"):
        engine.predicate(object())
    # the ticket retired anyway: the head advanced and nothing is
    # outstanding, so the next request commits immediately
    assert engine.gate.depth() == 0
    assert engine.gate.stats()["committed"] == 1


def test_make_intent_retires_ticket_even_when_finish_raises():
    engine = _engine()

    def exploding_finish(ticket):
        raise RuntimeError("finish blew up")

    engine.speculator.finish = exploding_finish
    with pytest.raises(RuntimeError, match="finish blew up"):
        engine.make_intent(object())
    assert engine.gate.depth() == 0


class _RecordingApi:
    def __init__(self):
        self.deletes = []

    def delete(self, kind, ns, name):
        self.deletes.append((kind, ns, name))


class _RecordingCache:
    def __init__(self):
        self.deletes = []

    def delete(self, ns, app_id):
        self.deletes.append((ns, app_id))


def test_recover_is_fenced_after_deposition(tmp_path):
    """The PC003 finding made real: a deposed replica replaying its
    evict journal must be refused before it deletes a single pod."""
    api = _RecordingApi()
    coord = PreemptionCoordinator(
        api, _RecordingCache(), journal_path=str(tmp_path / "evict")
    )
    coord._journal.record(
        "delete", EVICT_KIND, "ns1", "app-a", {"pods": ["p1", "p2"]}
    )

    deposed = FenceState()
    deposed.grant(1)
    deposed.observe(2)  # a newer leader exists
    coord.install_fence(FencedWriter(deposed))
    with pytest.raises(StaleEpochError):
        coord.recover()
    assert api.deletes == [], "deposed replica executed an eviction"

    # the live leader replays the same intent exactly once
    live = FenceState()
    live.grant(3)
    coord.install_fence(FencedWriter(live))
    assert coord.recover() == 1
    assert [d[1:] for d in api.deletes] == [("ns1", "p1"), ("ns1", "p2")]
    assert coord.recover() == 0  # acked: nothing left to replay


def test_recover_without_fence_still_replays_at_boot(tmp_path):
    """Wiring calls recover() before install_fence — the guard must be
    a no-op on the single-replica boot path."""
    api = _RecordingApi()
    coord = PreemptionCoordinator(
        api, _RecordingCache(), journal_path=str(tmp_path / "evict")
    )
    coord._journal.record("delete", EVICT_KIND, "ns1", "app-a", {"pods": ["p1"]})
    assert coord.recover() == 1
    assert len(api.deletes) == 1
