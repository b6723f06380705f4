"""Deterministic discrete-event cluster simulator; a copy of the
reference package's ``sim/`` that drives this package's wiring.

Drives the REAL scheduler wiring (embedded API server, full
``server/wiring.py`` Server, the queue solvers on the chosen device) on a
virtual clock:

- :mod:`.clock` — event heap + controllable time source (installed into
  :mod:`..timesource` so GC/failover/FIFO/unschedulable timers fire at
  simulated instants);
- :mod:`.workload` — seeded arrival/size/lifetime generators and JSONL
  trace replay;
- :mod:`.scenario` — declarative spec composing cluster shape, workload,
  autoscaler behavior, and injected faults;
- :mod:`.auditor` — per-event invariant auditing through
  ``scheduler/invariants.py`` plus FIFO-order and demand-hygiene checks;
- :mod:`.runner` — the engine + replayable event log with a content
  digest (same seed ⇒ identical digest, equal to the reference's) and a
  summary JSON.

CLI: ``python -m k8s_spark_scheduler_tpu_torch.sim --scenario examples/sim/chaos.json --seed 42``
(``--device cpu`` for the kernels' plain versions; CUDA by default).
"""

from .clock import VirtualClock
from .scenario import Scenario
from .runner import Simulation, SimulationResult

__all__ = ["VirtualClock", "Scenario", "Simulation", "SimulationResult"]
