"""``@guarded_by`` — declared lock discipline for mutable shared state;
a copy of the reference package's ``analysis/guarded.py``.

A class decorator that records, per class, which attributes are guarded
by which lock attribute::

    @guarded_by("_lock", "_store", "_observers")
    class ObjectStore: ...

The declaration is consumed at runtime twice:

- by the contention observatory (:mod:`..contention.locktime`): every
  instance's lock is wrapped in a ``TimedLock`` at construction (the
  always-on timing layer; it records wait/hold stats only while the
  process-wide timekeeper is enabled, and its disabled path costs one
  module-attribute read);
- by the race detectors (:mod:`.racecheck`): when the detector is
  active, instances created by a decorated class get their lock
  attribute wrapped in a tracked proxy so the detector knows exactly
  which locks each thread holds at every instrumented access.

In production the decorator therefore adds only the ``TimedLock``
shim: metadata registration plus a thin ``__init__`` wrapper.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple, Type

# class → (lock attribute name, tuple of guarded attribute names).
# Keyed by the class object itself so subclasses don't alias.
_REGISTRY: Dict[Type, Tuple[str, Tuple[str, ...]]] = {}


def guarded_by(lock_attr: str, *fields: str):
    """Declare that ``fields`` of the decorated class are only mutated
    while ``self.<lock_attr>`` is held.  ``lock_attr`` must be assigned
    in ``__init__``."""

    def decorate(cls):
        _REGISTRY[cls] = (lock_attr, tuple(fields))
        original_init = cls.__init__

        @functools.wraps(original_init)
        def init(self, *args, **kwargs):
            original_init(self, *args, **kwargs)
            # contention timing wraps the raw lock FIRST (always-on;
            # recording gates on the locktime switchboard), so when the
            # race detector is also active its TrackedLock proxy ends
            # up outermost and the timing layer measures the real lock
            from ..contention import locktime

            locktime.wrap_instance(self, cls, lock_attr)
            from . import racecheck

            if racecheck.active():
                racecheck.instrument_instance(self, cls, lock_attr)

        cls.__init__ = init
        return cls

    return decorate


def guarded_fields(cls: Type) -> Tuple[str, Tuple[str, ...]]:
    """(lock_attr, fields) declared for ``cls`` (or the nearest
    decorated base), or ``("", ())`` when undeclared."""
    for klass in cls.__mro__:
        if klass in _REGISTRY:
            return _REGISTRY[klass]
    return "", ()


def registry() -> Dict[Type, Tuple[str, Tuple[str, ...]]]:
    return dict(_REGISTRY)
