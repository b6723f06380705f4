"""Runtime lock discipline: the ``@guarded_by`` declarations and the
race detectors that check them (:mod:`.racecheck`: an Eraser lockset, a
vector-clock happens-before detector and a lock-order graph).

The runtime half of the reference package's ``analysis/``; its static
rules (the schedlint linter and the model checker) have no counterpart
here.  Set ``SCHEDLINT_RACECHECK=1`` before building a
``testing.harness.Harness`` to run the detectors over every guarded
instance the server builds.
"""

from .guarded import guarded_by, guarded_fields, registry  # noqa: F401
