"""schedlint for the PyTorch port: static analysis, the interleaving
model checker and runtime race detection.

The port's copy of the reference package's ``analysis/``.  Its rule
families:

- **TS/DT determinism** — every *semantic* clock read goes through
  :mod:`..timesource` (the simulator swaps in a virtual clock), and
  every random stream is explicitly seeded.  TS001 ``time.time()``,
  TS002 ``time.monotonic()`` (infra only: allowlist or pragma), TS003
  ``datetime.now()``/``utcnow()``/``today()``, DT001 unseeded
  ``random``, DT002 NumPy's global RNG.
- **LK lock discipline** — the mutable state behind the extender lock
  is declared with :func:`guarded_by`; LK001 a guarded mutation outside
  ``with self.<lock>:``, LK002 a bare ``.acquire()`` without
  ``try/finally``, LK003 a declaration whose lock ``__init__`` never
  assigns, LK004 a lock attribute with mutating methods and no
  declaration.  The runtime half is the lockset / happens-before
  detector (:mod:`.racecheck`).
- **NA device boundary** (:mod:`.rules_native`) — NA001 a call on the
  device session (``sess.native.solve``) while holding a guarded lock,
  NA002 a raw ``KernelLibrary`` CDLL (``LIBRARY.load()``, ``._lib``,
  ``ctypes.CDLL``) outside the kernel binding modules.
- **TK device contracts** (:mod:`.rules_torch`, in the place of the
  reference's JAX tracer-safety family) — TK001 a hand-kernel launch
  written in a ``try`` body whose handler does not re-raise (a fallback
  lane; a launch one call up, through a function that launches, is not
  resolved), TK002 a ``device`` parameter whose default is not ``None``
  (an entry point off the card), TK003 an import of ``jax``, ``jaxlib`` or the
  reference package.
- **PC protocol discipline** — flow-sensitive typestate over a real CFG
  (:mod:`.flow`): PC001/PC002 commit-gate tickets retire exactly once
  on *every* path, PC003 kube mutations are dominated by a fencing
  check from their entry points, PC004 journal intents are never acked
  before their execute, PC005 spans/locks close path-completely, PC006
  the extender's phase ladder re-arms its deadline at each boundary
  (:mod:`.rules_protocol`).
- **PR pragma hygiene** — PR000 a file that does not parse, PR001
  (``--strict``) a pragma without a justification.

Run it (``--list-rules`` prints the catalogue; exit 0 clean, 1
findings, 2 usage)::

    python -m k8s_spark_scheduler_tpu_torch.analysis --strict [--format json]
    python -m k8s_spark_scheduler_tpu_torch.tools.schedlint_diff --diff-baseline

Suppressions are inline pragmas with a mandatory justification in
strict mode, or allowlist entries (:data:`DEFAULT_ALLOWLIST`,
``--allowlist FILE``) with a ``why``::

    deadline = time.monotonic() + t  # schedlint: disable=TS002 -- bounded infra wait, must not freeze with the sim clock

The diff tool pins the suppressed findings to
``tests/baselines/torch_schedlint_suppressions.json``, so a new one is
reviewed.

The model checker explores thread interleavings of the guarded
components (:mod:`.mcscenarios`) under a cooperative scheduler
(:mod:`.modelcheck`)::

    python -m k8s_spark_scheduler_tpu_torch.analysis.modelcheck --device cpu --schedules 120 --seed 7

Set ``SCHEDLINT_RACECHECK=1`` before building a
``testing.harness.Harness`` to run the race detectors over every guarded
instance the server builds.
"""

from __future__ import annotations

from .core import (
    DEFAULT_ALLOWLIST,
    AnalysisConfig,
    AnalysisResult,
    Finding,
    SuppressedFinding,
    analyze_package,
    analyze_paths,
    analyze_paths_detailed,
    load_allowlist,
    package_root,
)
from .guarded import guarded_by, guarded_fields, registry
from .reporters import render_json, render_text

__all__ = [
    "AnalysisConfig",
    "AnalysisResult",
    "DEFAULT_ALLOWLIST",
    "Finding",
    "SuppressedFinding",
    "analyze_package",
    "analyze_paths",
    "analyze_paths_detailed",
    "guarded_by",
    "guarded_fields",
    "load_allowlist",
    "package_root",
    "registry",
    "render_json",
    "render_text",
]
