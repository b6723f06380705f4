"""The port's analyzer reads what the reference's reads.

Both packages' analyzers run over the same inputs with ``strict=True``,
no built-in allowlist, and the rule families the two share: TS, DT, LK,
NA001, PC and PR (JX is the reference's alone, TK the port's, and NA002
keys on a different boundary in each).  The inputs are the reference's
tree, the port's tree, every snippet of tests/test_schedlint.py and
tests/test_rules_protocol.py, and the PC rules' fixtures.  The
findings (rule, file, line, col, message, symbol), the suppressed channel
and the JSON report must be equal, the report byte for byte.  Each whole
tree is analyzed once per package (module-scoped fixtures).
"""

import ast
import os

import pytest

from k8s_spark_scheduler_tpu import analysis as reference
from k8s_spark_scheduler_tpu_torch import analysis as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = ("TS", "DT", "LK", "NA001", "PC", "PR")


def _config(package):
    return package.AnalysisConfig(strict=True, use_default_allowlist=False, select=SHARED)


def _run(package, paths, root):
    return package.analyze_paths_detailed(paths, config=_config(package), root=root)


def _as_dicts(result):
    return [f.to_dict() for f in result.findings], [s.to_dict() for s in result.suppressed]


def _json(package, result):
    return package.render_json(result.findings, strict=True, suppressed=result.suppressed)


@pytest.fixture(scope="module", params=["k8s_spark_scheduler_tpu", "k8s_spark_scheduler_tpu_torch"])
def tree(request):
    root = os.path.join(REPO, request.param)
    return request.param, _run(reference, [root], root), _run(port, [root], root)


def test_whole_tree_findings_and_suppressions_equal(tree):
    name, theirs, ours = tree
    assert _as_dicts(ours) == _as_dicts(theirs), name
    # on the port's own tree, what is left without the built-in allowlist
    # is what that allowlist covers; the pragmas hold the rest
    if name.endswith("_torch"):
        from k8s_spark_scheduler_tpu_torch.analysis.core import allowlisted

        assert ours.findings and all(allowlisted(port.DEFAULT_ALLOWLIST, f.rule, f.file) for f in ours.findings)
        assert len(ours.suppressed) >= 30 and all(s.via == "pragma" for s in ours.suppressed)


def test_whole_tree_json_reports_equal_byte_for_byte(tree):
    name, theirs, ours = tree
    assert _json(port, ours) == _json(reference, theirs), name


def _snippets(test_file):
    """(id, source) of every Python source in a test file: the string
    constants that parse and hold a statement beyond a docstring."""
    with open(os.path.join(REPO, "tests", test_file)) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and "\n" in node.value:
            try:
                body = ast.parse(node.value).body
            except SyntaxError:
                continue
            if body and not (len(body) == 1 and isinstance(body[0], ast.Expr)):
                out.append((f"{test_file}:{node.lineno}", node.value))
    return out


def _protocol_fixtures():
    """The PC rules' broken twins (tests/fixtures/protocol/)."""
    root = os.path.join(REPO, "tests", "fixtures", "protocol")
    return [
        (f"fixtures/protocol/{name}", open(os.path.join(root, name)).read())
        for name in sorted(os.listdir(root)) if name.endswith(".py")
    ]


SNIPPETS = _snippets("test_schedlint.py")
PROTOCOL = _snippets("test_rules_protocol.py") + _protocol_fixtures()


def test_snippet_corpus_is_every_rule_fixture():
    assert len(SNIPPETS) >= 20
    text = "".join(src for _, src in SNIPPETS)
    for marker in ("time.time()", "random.random()", "@guarded_by", "rows_equal", ".native.solve",
                   "match kind", "_handle", "jax.jit", "schedlint: disable=LK004"):
        assert marker in text, marker


def test_protocol_corpus_is_every_pc_fixture():
    assert len(PROTOCOL) >= 14
    text = "".join(src for _, src in PROTOCOL)
    for marker in ("gate.ticket()", "retire(", "_journal.record", "__enter__()", "_check_deadline",
                   "schedlint: entrypoints="):
        assert marker in text, marker


@pytest.mark.parametrize("where,source", SNIPPETS + PROTOCOL, ids=[w for w, _ in SNIPPETS + PROTOCOL])
@pytest.mark.parametrize("relpath", ["snippet.py", "native/snippet.py"])
def test_snippet_findings_and_reports_equal(tmp_path, where, source, relpath):
    path = tmp_path / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    theirs = _run(reference, [str(path)], str(tmp_path))
    ours = _run(port, [str(path)], str(tmp_path))
    assert _as_dicts(ours) == _as_dicts(theirs)
    assert _json(port, ours) == _json(reference, theirs)
    # lenient mode (no PR001) agrees too
    lenient = [
        package.analyze_paths(
            [str(path)], config=package.AnalysisConfig(use_default_allowlist=False, select=SHARED),
            root=str(tmp_path),
        )
        for package in (reference, port)
    ]
    assert [f.to_dict() for f in lenient[1]] == [f.to_dict() for f in lenient[0]]


def test_snippets_raise_findings_in_every_shared_family(tmp_path):
    """The snippet corpus exercises the shared rules, so the equality
    above is not an equality of empty lists."""
    rules = set()
    for i, (_, source) in enumerate(SNIPPETS + PROTOCOL):
        path = tmp_path / f"s{i}.py"
        path.write_text(source)
        rules |= {f.rule for f in _run(port, [str(path)], str(tmp_path)).findings}
    want = {"TS001", "DT001", "LK001", "LK004", "NA001", "PR001",
            "PC001", "PC002", "PC003", "PC004", "PC005", "PC006"}
    assert want <= rules, rules
