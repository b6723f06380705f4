"""Exact-arithmetic Kubernetes resource quantities.

The reference scheduler does all feasibility math on k8s
``resource.Quantity`` values (arbitrary-precision decimals with SI /
binary-SI suffixes) — see
the reference's ``pkg/resources/resources.go:151-155`` and the
capacity floor-division at
``pkg/capacity/capacity.go:36-54`` which uses
``inf.Dec`` exact arithmetic.  Feasibility decisions must therefore never
go through floats.  We represent a quantity as an exact
``fractions.Fraction`` which is a strict superset of inf.Dec's decimals,
so every reference result is reproduced bit-for-bit.

The batch solver works on integer tensors (milli-CPU / bytes /
milli-GPU); :meth:`Quantity.milli_value_exact` reports whether a value is
exactly representable so the solver can guarantee oracle parity.
"""

from __future__ import annotations

import math
import re
from fractions import Fraction
from typing import Union

_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
    "Ki": Fraction(2**10),
    "Mi": Fraction(2**20),
    "Gi": Fraction(2**30),
    "Ti": Fraction(2**40),
    "Pi": Fraction(2**50),
    "Ei": Fraction(2**60),
}

# decimal exponent ("1e3") takes precedence over the "E" (exa) suffix,
# matching k8s parsing: the exponent form requires digits after e/E.
_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)"
    r"(?P<num>\d+(?:\.\d*)?|\.\d+)"
    r"(?:(?P<exp>[eE][+-]?\d+)|(?P<suffix>n|u|m|k|M|G|T|P|E|Ki|Mi|Gi|Ti|Pi|Ei))?$"
)

QuantityLike = Union["Quantity", str, int, float, Fraction]


class Quantity:
    """An exact, immutable resource quantity.

    Mirrors the observable behavior of k8s ``resource.Quantity``: exact
    decimal arithmetic, any-precision compare, and ceil-to-int64
    ``value()`` / ``milli_value()`` accessors.
    """

    __slots__ = ("_v", "_s")

    def __init__(self, value: QuantityLike = 0, _s: str | None = None):
        if isinstance(value, Quantity):
            self._v = value._v
            self._s = value._s
        elif isinstance(value, str):
            self._v = _parse(value)
            self._s = value
        elif isinstance(value, (int, Fraction)):
            self._v = Fraction(value)
            self._s = _s
        elif isinstance(value, float):
            if not value.is_integer():
                raise ValueError(
                    f"refusing to build a Quantity from non-integral float {value!r}; "
                    "use a string or Fraction for exactness"
                )
            self._v = Fraction(int(value))
            self._s = _s
        else:
            raise TypeError(f"cannot build Quantity from {type(value)!r}")

    # -- accessors ---------------------------------------------------------

    @property
    def exact(self) -> Fraction:
        return self._v

    def value(self) -> int:
        """Ceil to integer, like k8s Quantity.Value()."""
        return math.ceil(self._v)

    def milli_value(self) -> int:
        """Ceil of value*1000, like k8s Quantity.MilliValue()."""
        return math.ceil(self._v * 1000)

    def milli_value_exact(self) -> tuple[int, bool]:
        """(milli value, whether the quantity is exactly milli-integral)."""
        v = self._v * 1000
        return math.ceil(v), v.denominator == 1

    def is_zero(self) -> bool:
        return self._v == 0

    # -- arithmetic (immutable; callers rebind) ----------------------------

    def add(self, other: "Quantity") -> "Quantity":
        return Quantity(self._v + other._v)

    def sub(self, other: "Quantity") -> "Quantity":
        return Quantity(self._v - other._v)

    def neg(self) -> "Quantity":
        return Quantity(-self._v)

    def cmp(self, other: "Quantity") -> int:
        if self._v < other._v:
            return -1
        if self._v > other._v:
            return 1
        return 0

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Quantity) and self._v == other._v

    def __lt__(self, other: "Quantity") -> bool:
        return self._v < other._v

    def __le__(self, other: "Quantity") -> bool:
        return self._v <= other._v

    def __hash__(self) -> int:
        return hash(self._v)

    def __repr__(self) -> str:
        return f"Quantity({self.serialize()!r})"

    # -- serialization ------------------------------------------------------

    def serialize(self) -> str:
        """A parseable string form. Round-trips the original text if the
        quantity was built from one; otherwise emits a canonical decimal.
        """
        if self._s is not None:
            return self._s
        return _format(self._v)

    def copy(self) -> "Quantity":
        return self  # immutable


def _parse(s: str) -> Fraction:
    text = s.strip()
    m = _QUANTITY_RE.match(text)
    if m is None:
        raise ValueError(f"unparseable quantity {s!r}")
    num = Fraction(m.group("num"))
    if m.group("sign") == "-":
        num = -num
    exp = m.group("exp")
    if exp:
        num *= Fraction(10) ** int(exp[1:])
    suffix = m.group("suffix") or ""
    return num * _SUFFIXES[suffix]


def _format(v: Fraction) -> str:
    if v.denominator == 1:
        return str(v.numerator)
    milli = v * 1000
    if milli.denominator == 1:
        return f"{milli.numerator}m"
    nano = v * 10**9
    if nano.denominator == 1:
        return f"{nano.numerator}n"
    # fall back to an exact decimal expansion if possible, else a fraction
    # of nano-units rounded up (never rounds availability up vs demand:
    # callers only hit this path for display).
    return f"{math.ceil(nano)}n"


def parse_quantity(s: QuantityLike) -> Quantity:
    return s if isinstance(s, Quantity) else Quantity(s)


def zero() -> Quantity:
    return Quantity(0)
