"""The port's schedlint: its self-check over the port's tree, the
reference's analyzer cases (tests/test_schedlint.py) against the port's
analyzer, and the port's own rules (NA002 on the kernel libraries,
TK001-TK003).

The self-check is the gate: the port's analyzer runs over the whole
``k8s_spark_scheduler_tpu_torch`` package in --strict mode and must
report ZERO findings, and its suppressions must equal the committed
baseline (tests/baselines/torch_schedlint_suppressions.json).
"""

import json
import os

import pytest

from k8s_spark_scheduler_tpu_torch.analysis import (
    AnalysisConfig,
    analyze_package,
    analyze_paths,
    load_allowlist,
    render_json,
    render_text,
)
from k8s_spark_scheduler_tpu_torch.analysis.__main__ import main as cli_main
from k8s_spark_scheduler_tpu_torch.analysis.core import (
    Finding,
    extract_pragmas,
    merge_allowlists,
)


# -- the tier-1 self-check ----------------------------------------------------


def test_package_is_schedlint_clean_strict():
    findings = analyze_package(AnalysisConfig(strict=True))
    assert findings == [], "schedlint findings:\n" + render_text(findings)


def test_cli_strict_exits_zero(capsys):
    assert cli_main(["--strict"]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_list_rules_covers_all_families(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("TS001", "TS002", "TS003", "DT001", "LK001", "LK002",
                 "LK003", "LK004", "TK001", "TK002", "TK003",
                 "NA001", "NA002", "PC001", "PC002", "PC003", "PC004",
                 "PC005", "PC006", "PR001"):
        assert rule in out
    # grouped by family: the family header precedes its rules
    assert out.index("PC  ") < out.index("PC001")


def test_cli_unknown_select_family_is_an_error(capsys):
    # a typo must not silently select nothing and report "clean"
    assert cli_main(["--select", "QZ"]) == 2
    err = capsys.readouterr().err
    assert "QZ" in err and "unknown" in err


def test_cli_mixed_select_with_unknown_token_is_an_error(capsys):
    assert cli_main(["--select", "TS,PCX01"]) == 2
    assert "PCX01" in capsys.readouterr().err


def test_cli_select_known_rule_prefixes_ok(capsys):
    # exact rule ids and bare families both validate
    assert cli_main(["--select", "PC003,LK", "--strict"]) == 0
    assert "clean" in capsys.readouterr().out


# -- pragma suppression -------------------------------------------------------


def _analyze_snippet(tmp_path, source, strict=False, use_default_allowlist=False,
                     allowlist=None):
    f = tmp_path / "snippet.py"
    f.write_text(source)
    config = AnalysisConfig(
        strict=strict,
        use_default_allowlist=use_default_allowlist,
        allowlist=allowlist or {},
    )
    return analyze_paths([str(f)], config=config, root=str(tmp_path))


BAD_TIME = "import time\n\ndef stamp():\n    return time.time()\n"


def test_finding_without_pragma(tmp_path):
    findings = _analyze_snippet(tmp_path, BAD_TIME)
    assert [f.rule for f in findings] == ["TS001"]
    assert findings[0].file == "snippet.py"
    assert findings[0].line == 4


def test_same_line_pragma_suppresses(tmp_path):
    src = (
        "import time\n\ndef stamp():\n"
        "    return time.time()  # schedlint: disable=TS001 -- test fixture\n"
    )
    assert _analyze_snippet(tmp_path, src) == []


def test_previous_line_pragma_suppresses(tmp_path):
    src = (
        "import time\n\ndef stamp():\n"
        "    # schedlint: disable=TS001 -- test fixture\n"
        "    return time.time()\n"
    )
    assert _analyze_snippet(tmp_path, src) == []


def test_pragma_for_other_rule_does_not_suppress(tmp_path):
    src = (
        "import time\n\ndef stamp():\n"
        "    return time.time()  # schedlint: disable=TS002 -- wrong rule\n"
    )
    assert [f.rule for f in _analyze_snippet(tmp_path, src)] == ["TS001"]


def test_disable_all_pragma(tmp_path):
    src = (
        "import time\n\ndef stamp():\n"
        "    return time.time()  # schedlint: disable=all -- test fixture\n"
    )
    assert _analyze_snippet(tmp_path, src) == []


def test_strict_requires_justification(tmp_path):
    src = (
        "import time\n\ndef stamp():\n"
        "    return time.time()  # schedlint: disable=TS001\n"
    )
    # lenient: pragma works, no complaint
    assert _analyze_snippet(tmp_path, src, strict=False) == []
    # strict: the unjustified pragma is itself a finding
    findings = _analyze_snippet(tmp_path, src, strict=True)
    assert [f.rule for f in findings] == ["PR001"]
    assert "justification" in findings[0].message


def test_extract_pragmas_parses_rules_and_why():
    src = "x = 1  # schedlint: disable=TS001,LK002 -- because reasons\n"
    (p,) = extract_pragmas(src)
    assert p.rules == ("TS001", "LK002")
    assert p.why == "because reasons"
    assert p.line == 1
    src2 = "# schedlint: disable=TS001\nx = 1\n"
    (p2,) = extract_pragmas(src2)
    assert p2.line == 2 and p2.pragma_line == 1 and p2.why is None


# -- allowlist loading --------------------------------------------------------


def test_allowlist_suppresses_by_path_prefix(tmp_path):
    allow = {"TS001": [{"path": "snippet.py", "why": "test fixture"}]}
    assert _analyze_snippet(tmp_path, BAD_TIME, allowlist=allow) == []
    # a prefix that does not match leaves the finding
    allow = {"TS001": [{"path": "other/", "why": "test fixture"}]}
    assert len(_analyze_snippet(tmp_path, BAD_TIME, allowlist=allow)) == 1


def test_load_allowlist_roundtrip(tmp_path):
    path = tmp_path / "allow.json"
    path.write_text(json.dumps({"TS002": [{"path": "x/", "why": "infra"}]}))
    loaded = load_allowlist(str(path))
    assert loaded == {"TS002": [{"path": "x/", "why": "infra"}]}


def test_load_allowlist_rejects_missing_why(tmp_path):
    path = tmp_path / "allow.json"
    path.write_text(json.dumps({"TS002": [{"path": "x/"}]}))
    with pytest.raises(ValueError, match="justification"):
        load_allowlist(str(path))


def test_load_allowlist_rejects_malformed(tmp_path):
    path = tmp_path / "allow.json"
    path.write_text(json.dumps(["not", "a", "dict"]))
    with pytest.raises(ValueError):
        load_allowlist(str(path))


def test_merge_allowlists_concatenates_entries():
    a = {"TS001": [{"path": "a", "why": "w"}]}
    b = {"TS001": [{"path": "b", "why": "w"}], "LK001": [{"path": "c", "why": "w"}]}
    merged = merge_allowlists(a, b)
    assert [e["path"] for e in merged["TS001"]] == ["a", "b"]
    assert "LK001" in merged


# -- JSON reporter schema -----------------------------------------------------


def test_json_reporter_schema_stable_keys(tmp_path):
    findings = _analyze_snippet(tmp_path, BAD_TIME)
    doc = json.loads(render_json(findings, strict=True))
    # keys are only ever ADDED to this schema ("suppressed" rode in
    # without a version bump); renames/removals bump schema_version
    assert set(doc) == {
        "schema_version", "tool", "strict", "findings", "counts", "suppressed",
    }
    assert doc["schema_version"] == 1
    assert doc["tool"] == "schedlint"
    assert doc["strict"] is True
    (f,) = doc["findings"]
    assert set(f) == {"rule", "category", "file", "line", "col", "message", "symbol"}
    assert doc["counts"]["total"] == 1
    assert doc["counts"]["by_rule"] == {"TS001": 1}
    assert doc["counts"]["by_category"] == {"determinism": 1}


def test_json_reporter_empty_run():
    doc = json.loads(render_json([]))
    assert doc["findings"] == []
    assert doc["counts"] == {"total": 0, "by_rule": {}, "by_category": {}}


def test_json_output_is_deterministic(tmp_path):
    findings = _analyze_snippet(tmp_path, BAD_TIME)
    assert render_json(findings) == render_json(list(findings))


def test_findings_sorted_by_location(tmp_path):
    src = (
        "import time\nimport random\n\n"
        "def b():\n    return time.time()\n\n"
        "def a():\n    return random.random()\n"
    )
    findings = _analyze_snippet(tmp_path, src)
    assert [f.rule for f in findings] == ["TS001", "DT001"]
    assert findings == sorted(findings, key=Finding.sort_key)


# -- the suppressed channel + baseline gate -----------------------------------


def test_suppressed_channel_records_pragma_with_why(tmp_path):
    from k8s_spark_scheduler_tpu_torch.analysis import analyze_paths_detailed

    src = (
        "import time\n\ndef stamp():\n"
        "    return time.time()  # schedlint: disable=TS001 -- test clock\n"
    )
    f = tmp_path / "snippet.py"
    f.write_text(src)
    result = analyze_paths_detailed(
        [str(f)],
        config=AnalysisConfig(use_default_allowlist=False),
        root=str(tmp_path),
    )
    assert result.findings == []
    (s,) = result.suppressed
    assert (s.finding.rule, s.via, s.why) == ("TS001", "pragma", "test clock")
    doc = s.to_dict()
    assert doc["suppressed_via"] == "pragma" and doc["why"] == "test clock"


def _load_schedlint_diff():
    from k8s_spark_scheduler_tpu_torch.tools import schedlint_diff

    return schedlint_diff


def test_diff_baseline_flags_new_suppressions(tmp_path, monkeypatch, capsys):
    mod = _load_schedlint_diff()
    monkeypatch.setattr(
        mod,
        "current_suppressions",
        lambda: [
            {"rule": "TS001", "file": "a.py", "symbol": "f", "suppressed_via": "pragma"},
        ],
    )
    empty = tmp_path / "baseline.json"
    empty.write_text(json.dumps({"suppressions": []}))
    assert mod.diff_baseline(str(empty)) == 1
    out = capsys.readouterr().out
    assert "NEW suppressions" in out and "TS001" in out


def test_diff_baseline_accepts_committed_counts(tmp_path, monkeypatch):
    mod = _load_schedlint_diff()
    current = [
        {"rule": "TS001", "file": "a.py", "symbol": "f", "suppressed_via": "pragma"},
    ]
    monkeypatch.setattr(mod, "current_suppressions", lambda: current)
    baseline = tmp_path / "baseline.json"
    baseline.write_text(
        json.dumps(
            {
                "suppressions": [
                    {"rule": "TS001", "file": "a.py", "symbol": "f",
                     "via": "pragma", "count": 1},
                ]
            }
        )
    )
    assert mod.diff_baseline(str(baseline)) == 0
    # line drift within the same (rule, file, symbol, via) key is free,
    # but a SECOND suppression under that key is new again
    monkeypatch.setattr(mod, "current_suppressions", lambda: current * 2)
    assert mod.diff_baseline(str(baseline)) == 1


def test_committed_suppression_baseline_is_current():
    """The committed baseline must match the tree: a change that adds a
    pragma or allowlist entry regenerates it (--write-baseline) so the
    new justification gets reviewed."""
    mod = _load_schedlint_diff()
    assert mod.DEFAULT_BASELINE.endswith(os.path.join("tests", "baselines", "torch_schedlint_suppressions.json"))
    assert mod.diff_baseline(mod.DEFAULT_BASELINE) == 0
    # and no baseline key is stale: the baseline is exactly the tree's
    with open(mod.DEFAULT_BASELINE) as f:
        baseline = {(e["rule"], e["file"], e["symbol"], e["via"]): e["count"] for e in json.load(f)["suppressions"]}
    assert baseline == mod.count_by_key(mod.current_suppressions())


# -- representative rule behavior --------------------------------------------


def test_lk001_respects_with_lock_scope(tmp_path):
    src = """
import threading
from k8s_spark_scheduler_tpu_torch.analysis.guarded import guarded_by

@guarded_by("_lock", "_state")
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}

    def good(self, k):
        with self._lock:
            self._state[k] = 1

    def bad(self, k):
        self._state[k] = 1
"""
    findings = _analyze_snippet(tmp_path, src)
    assert [f.rule for f in findings] == ["LK001"]
    assert findings[0].symbol == "C.bad"


def test_lk004_flags_undeclared_lock_with_mutating_methods(tmp_path):
    src = """
import threading

class HasLockNoDecl:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}

    def mutate(self, k):
        with self._lock:
            self._state[k] = 1
"""
    findings = _analyze_snippet(tmp_path, src)
    assert [f.rule for f in findings] == ["LK004"]
    assert findings[0].symbol == "HasLockNoDecl"


def test_lk004_quiet_cases(tmp_path):
    src = """
import threading
from k8s_spark_scheduler_tpu_torch.analysis.guarded import guarded_by

@guarded_by("_lock", "_state")
class Declared:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}

    def mutate(self, k):
        with self._lock:
            self._state[k] = 1

class LockButReadOnly:
    def __init__(self):
        self._lock = threading.RLock()
        self._state = {}

    def peek(self, k):
        with self._lock:
            return self._state.get(k)

class MutatesButNoLock:
    def __init__(self):
        self._state = {}

    def mutate(self, k):
        self._state[k] = 1
"""
    assert _analyze_snippet(tmp_path, src) == []


def test_lk004_pragma_on_class_line(tmp_path):
    src = """
import threading

class Serializer:  # schedlint: disable=LK004 -- pure serializer lock, guards flow not fields
    def __init__(self):
        self._lock = threading.Lock()
        self.hits = 0

    def bump(self):
        with self._lock:
            self.hits += 1
"""
    assert _analyze_snippet(tmp_path, src) == []


def test_na001_flags_native_call_under_guarded_lock(tmp_path):
    src = """
import threading
from k8s_spark_scheduler_tpu_torch.analysis.guarded import guarded_by
from k8s_spark_scheduler_tpu_torch.native import rows_equal

@guarded_by("_lock", "_basis")
class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._basis = None

    def bad(self, a, b):
        with self._lock:
            return rows_equal(a, b)

    def good(self, a, b):
        with self._lock:
            basis = self._basis
        return rows_equal(a, basis)

    def gil_safe_ok(self, sess):
        with self._lock:
            return sess.native.mem_bytes()
"""
    findings = _analyze_snippet(tmp_path, src)
    assert [f.rule for f in findings] == ["NA001"]
    assert findings[0].symbol == "Engine.bad"
    assert "GIL" in findings[0].message


def test_na001_reports_nested_call_exactly_once(tmp_path):
    # a call buried two blocks deep under the lock must yield ONE
    # finding, not one per nesting level (regression: the walker used
    # to both ast.walk the statement and recurse into its blocks)
    src = """
import threading
from k8s_spark_scheduler_tpu_torch.analysis.guarded import guarded_by
from k8s_spark_scheduler_tpu_torch.native import rows_equal

@guarded_by("_lock", "_basis")
class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._basis = None

    def bad(self, a, b):
        with self._lock:
            if a is not None:
                try:
                    return rows_equal(a, b)
                finally:
                    pass
"""
    findings = _analyze_snippet(tmp_path, src)
    assert [f.rule for f in findings] == ["NA001"]


def test_na001_ignores_deferred_nested_functions(tmp_path):
    # a function DEFINED under the lock runs later, lock-free: its
    # native calls are not in-lock crossings
    src = """
import threading
from k8s_spark_scheduler_tpu_torch.analysis.guarded import guarded_by
from k8s_spark_scheduler_tpu_torch.native import rows_equal

@guarded_by("_lock", "_cb")
class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._cb = None

    def ok(self, a, b):
        with self._lock:
            def later():
                return rows_equal(a, b)
            self._cb = later
"""
    assert _analyze_snippet(tmp_path, src) == []


def test_na001_flags_attribute_chain_receivers(tmp_path):
    src = """
import threading
from k8s_spark_scheduler_tpu_torch.analysis.guarded import guarded_by

@guarded_by("_lock", "_sessions")
class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._sessions = {}

    def bad(self, key):
        with self._lock:
            return self._sessions[key].native.solve(None)
"""
    findings = _analyze_snippet(tmp_path, src)
    assert [f.rule for f in findings] == ["NA001"]


def test_na001_and_lk001_see_inside_match_arms(tmp_path):
    # `match` case bodies are block statements too: a native call under
    # the lock, or a guarded mutation outside it, must not hide there
    src = """
import threading
from k8s_spark_scheduler_tpu_torch.analysis.guarded import guarded_by
from k8s_spark_scheduler_tpu_torch.native import rows_equal

@guarded_by("_lock", "_state")
class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}

    def na_in_match(self, kind, a, b):
        with self._lock:
            match kind:
                case "eq":
                    return rows_equal(a, b)
        return None

    def lk_in_match(self, kind, k):
        match kind:
            case "set":
                self._state[k] = 1
"""
    findings = _analyze_snippet(tmp_path, src)
    assert sorted(f.rule for f in findings) == ["LK001", "NA001"]


def test_na002_no_longer_keys_on_handle(tmp_path):
    # the reference's marker: a ``_handle`` attribute.  The port has no
    # native handle, and ``self._handle(r)`` is a method (state/cache.py)
    src = """
def leak(sess):
    return sess._handle

class Cache:
    def worker(self, r):
        self._handle(r)
"""
    assert _analyze_snippet(tmp_path, src) == []


NA002_SRC = """
import ctypes
from k8s_spark_scheduler_tpu_torch.ops import queue_kernel
from k8s_spark_scheduler_tpu_torch.ops.queue_kernel import LIBRARY

def raw_launch(args):
    lib = queue_kernel.LIBRARY.load()
    return lib.fifo_queue_launch(*args)

def raw_cdll(path):
    return ctypes.CDLL(path)

def peek(library):
    return library._lib

def local(args):
    return LIBRARY.load().fifo_queue_launch(*args)
"""


def test_na002_flags_kernel_library_outside_binding_modules(tmp_path):
    findings = _analyze_snippet(tmp_path, NA002_SRC)
    assert [(f.rule, f.line, f.symbol) for f in findings] == [
        ("NA002", 7, "raw_launch"), ("NA002", 11, "raw_cdll"), ("NA002", 14, "peek"), ("NA002", 17, "local"),
    ]
    assert "kernel binding modules" in findings[0].message
    assert "queue_kernel.LIBRARY.load()" in findings[0].message


@pytest.mark.parametrize("binding", [
    "ops/cuda_build.py", "ops/queue_kernel.py", "ops/minfrag_kernel.py", "ops/single_az_kernel.py",
    "ops/class_kernel.py",
])
def test_na002_allows_the_binding_modules(tmp_path, binding):
    f = tmp_path / binding
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(NA002_SRC)
    config = AnalysisConfig(use_default_allowlist=False, select=("NA",))
    assert analyze_paths([str(f)], config=config, root=str(tmp_path)) == []


def test_na002_does_not_flag_the_port_cache_worker():
    """The reference's analyzer flags ``self._handle(r)`` in the port's
    state/cache.py (a method, not a native handle); the port's does not."""
    from k8s_spark_scheduler_tpu_torch.analysis import package_root

    path = os.path.join(package_root(), "state", "cache.py")
    assert "self._handle(r)" in open(path).read()
    config = AnalysisConfig(use_default_allowlist=False, strict=True, select=("NA",))
    assert analyze_paths([path], config=config, root=package_root()) == []


def test_selecting_rule_families(tmp_path):
    src = "import time\nimport random\nt = time.time()\nr = random.random()\n"
    f = tmp_path / "snippet.py"
    f.write_text(src)
    config = AnalysisConfig(select=("DT",), use_default_allowlist=False)
    findings = analyze_paths([str(f)], config=config, root=str(tmp_path))
    assert [x.rule for x in findings] == ["DT001"]


# -- TK: the port's device contracts -------------------------------------------


TK001_SRC = """
import logging
from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel
from k8s_spark_scheduler_tpu_torch.ops.queue_kernel import LIBRARY, fifo_queue

def fallback_to_plain(args, plain):
    try:
        return fifo_queue(*args)
    except RuntimeError:
        return plain(*args)

def swallowed(args):
    lib = LIBRARY.load()
    try:
        lib.fifo_queue_launch(*args)
    except Exception:
        logging.exception("launch failed")

def module_call(args):
    try:
        return minfrag_kernel.fifo_queue_min_frag(*args)
    except (RuntimeError, ValueError):
        return None

def reraised(args):
    try:
        return fifo_queue(*args)
    except RuntimeError as exc:
        logging.error("launch failed")
        raise RuntimeError("the queue kernel failed") from exc

def cleanup_only(args, stream):
    try:
        return fifo_queue(*args)
    finally:
        stream.synchronize()

def deferred(args):
    try:
        def later():
            return fifo_queue(*args)
    except Exception:
        later = None
    return later
"""


def test_tk001_flags_a_launch_under_a_fallback_handler(tmp_path):
    findings = [f for f in _analyze_snippet(tmp_path, TK001_SRC) if f.rule.startswith("TK")]
    assert [(f.rule, f.line, f.symbol) for f in findings] == [
        ("TK001", 8, "fallback_to_plain"),
        ("TK001", 15, "swallowed"),
        ("TK001", 21, "module_call"),
    ]
    assert "does not re-raise" in findings[0].message
    assert findings[0].category == "device"


TK002_SRC = """
from typing import Any, Callable, Optional, Sequence

from ..device import DeviceLike


def run_world(
    fn: Callable,
    ranks: int,
    device: str = "cpu",
    backend: Optional[str] = None,
    args: Sequence[Any] = (),
    local_ranks: Optional[int] = None,
    timeout_s: float = 600.0,
):
    pass


class Solver:
    def __init__(self, policy, *, device="cuda"):
        pass

    def fine(self, device: DeviceLike = None):
        pass

    def required(self, device):
        pass
"""


def test_tk002_flags_a_device_default_off_the_card(tmp_path):
    """The old ``parallel/launch.run_world`` signature is flagged; None
    and a required device are not."""
    findings = _analyze_snippet(tmp_path, TK002_SRC)
    assert [(f.rule, f.line, f.symbol) for f in findings] == [
        ("TK002", 10, "run_world"), ("TK002", 20, "Solver.__init__"),
    ]
    assert "'cpu'" in findings[0].message


def test_tk003_flags_jax_and_the_reference_package(tmp_path):
    src = """
import importlib
import jax
import jax.numpy as jnp
import jaxlib
from k8s_spark_scheduler_tpu.analysis import guarded
from k8s_spark_scheduler_tpu_torch.analysis import racecheck
from . import flow
import jaxtyping

def late():
    from jax import lax
    return importlib.import_module("k8s_spark_scheduler_tpu.ops.registry")
"""
    findings = _analyze_snippet(tmp_path, src)
    assert [(f.rule, f.line) for f in findings] == [
        ("TK003", 3), ("TK003", 4), ("TK003", 5), ("TK003", 6), ("TK003", 12), ("TK003", 13),
    ]
    assert findings[4].symbol == "late"


def test_tk_and_na002_find_nothing_in_the_port():
    """No finding, and no pragma or allowlist entry silencing one."""
    from k8s_spark_scheduler_tpu_torch.analysis import analyze_paths_detailed, package_root

    result = analyze_paths_detailed(
        [package_root()], config=AnalysisConfig(strict=True, select=("TK", "NA002")), root=package_root()
    )
    assert result.findings == [] and result.suppressed == []


def test_default_allowlist_is_the_reference_less_the_tpu_probe():
    from k8s_spark_scheduler_tpu.analysis.core import DEFAULT_ALLOWLIST as REFERENCE
    from k8s_spark_scheduler_tpu_torch.analysis import DEFAULT_ALLOWLIST

    dropped = {"path": "utils/tpuprobe.py", "why": "subprocess probe timeout bounds real wall time"}
    assert dropped in REFERENCE["TS002"]
    expected = {rule: [e for e in entries if e != dropped] for rule, entries in REFERENCE.items()}
    assert DEFAULT_ALLOWLIST == expected
    assert all(e["why"].strip() for entries in DEFAULT_ALLOWLIST.values() for e in entries)


def test_one_allowlist_file_loads_the_same_in_both_packages(tmp_path):
    from k8s_spark_scheduler_tpu.analysis import load_allowlist as reference_load

    path = tmp_path / "allow.json"
    path.write_text(json.dumps({"TS002": [{"path": "x/", "why": "infra"}], "LK002": []}))
    assert load_allowlist(str(path)) == reference_load(str(path))
    path.write_text(json.dumps({"TS002": [{"path": "x/"}]}))
    for load in (load_allowlist, reference_load):
        with pytest.raises(ValueError, match="justification"):
            load(str(path))


def test_protocol_entrypoints_resolve_in_the_port():
    """Every PC003 root names a unit of the port's index: otherwise the
    fence-dominance rule would silently check nothing."""
    import ast as _ast

    from k8s_spark_scheduler_tpu_torch.analysis import flow, package_root
    from k8s_spark_scheduler_tpu_torch.analysis.core import FileContext
    from k8s_spark_scheduler_tpu_torch.analysis.rules_protocol import DEFAULT_ENTRYPOINTS

    contexts = []
    for relpath in DEFAULT_ENTRYPOINTS:
        with open(os.path.join(package_root(), relpath)) as f:
            source = f.read()
        contexts.append(FileContext(relpath, source, _ast.parse(source)))
    index = flow.PackageIndex(contexts)
    qualnames = [(rel, q) for rel, quals in DEFAULT_ENTRYPOINTS.items() for q in quals]
    assert len(qualnames) >= 8
    for key in qualnames:
        assert key in index.units, key


def test_cli_json_format_reports_the_port_clean(capsys):
    assert cli_main(["--strict", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == [] and doc["counts"]["total"] == 0
    assert len(doc["suppressed"]) >= 50
    assert all(s["why"].strip() for s in doc["suppressed"])


def test_cli_allowlist_flags(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"TS002": [{"path": "x/"}]}))
    assert cli_main(["--allowlist", str(bad)]) == 2
    assert "bad allowlist" in capsys.readouterr().err
    # without the built-in allowlist the infra waits it covers surface
    snippet = tmp_path / "testing" / "wait.py"
    snippet.parent.mkdir()
    snippet.write_text("import time\n\ndef wait():\n    return time.monotonic()\n")
    assert cli_main([str(snippet), "--select", "TS"]) == 1
    assert "TS002" in capsys.readouterr().out


def test_cli_module_runs_as_a_program():
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_spark_scheduler_tpu_torch.analysis", "--list-rules"],
        capture_output=True, text=True, timeout=120, cwd=repo,
    )
    assert proc.returncode == 0, proc.stderr
    assert "TK  " in proc.stdout and "JX" not in proc.stdout
