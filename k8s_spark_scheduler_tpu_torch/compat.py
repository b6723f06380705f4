"""Reference-quirk compatibility policy.

The reference scheduler has a few accidental-looking behaviors that are
load-bearing for decision parity.  The port replicates them exactly as
the JAX package does (each site carries a ``# QUIRK`` comment).  The
install key ``strict-reference-parity`` (default on) lets operators opt
out of the ones that are safe to correct per deployment; in this package
it reaches the minimal-fragmentation efficiency omission (the host
oracles, the ``tpu-batch*-minimal-fragmentation`` binpackers and their
FIFO solvers).

Not switchable: the FIFO post-placement usage subtraction assigns (not
accumulates) per-node entries (``sparkpods.go:139-146``;
``ops/batch_solver.usage_delta`` and the queue kernel).
"""

DEFAULT_STRICT = True
