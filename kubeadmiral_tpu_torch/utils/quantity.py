"""Kubernetes resource.Quantity parsing.

Implements the subset of quantity semantics the control plane relies on
(reference usage: k8s.io/apimachinery resource.Quantity via
pkg/controllers/scheduler/framework/util.go NewResource): decimal SI
suffixes (m, k, M, G, T, P, E), binary suffixes (Ki..Ei), plain and
scientific notation.  ``value()`` rounds **up** to an integer and
``milli_value()`` rounds up at milli precision, matching Go's
``Quantity.Value()`` / ``MilliValue()`` ceiling behavior that the
scheduler's resource math inherits.
"""

from __future__ import annotations

import functools
import math
import re
from fractions import Fraction

_SUFFIXES: dict[str, Fraction] = {
    "": Fraction(1),
    "n": Fraction(1, 1000**3),
    "u": Fraction(1, 1000**2),
    "m": Fraction(1, 1000),
    "k": Fraction(1000),
    "M": Fraction(1000**2),
    "G": Fraction(1000**3),
    "T": Fraction(1000**4),
    "P": Fraction(1000**5),
    "E": Fraction(1000**6),
    "Ki": Fraction(1024),
    "Mi": Fraction(1024**2),
    "Gi": Fraction(1024**3),
    "Ti": Fraction(1024**4),
    "Pi": Fraction(1024**5),
    "Ei": Fraction(1024**6),
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>[0-9]+(?:\.[0-9]*)?|\.[0-9]+)"
    r"(?:[eE](?P<exp>[+-]?[0-9]+))?"
    r"(?P<suffix>n|u|m|k|M|G|T|P|E|Ki|Mi|Gi|Ti|Pi|Ei)?$"
)


class Quantity:
    """An exact rational quantity with k8s-style string forms."""

    __slots__ = ("_value", "_text")

    def __init__(self, value: "Fraction | int | str | Quantity"):
        if isinstance(value, Quantity):
            self._value: Fraction = value._value
            self._text = value._text
            return
        if isinstance(value, str):
            self._value = _parse(value)
            self._text: str | None = value
        else:
            self._value = Fraction(value)
            self._text = None

    @property
    def raw(self) -> Fraction:
        return self._value

    def value(self) -> int:
        """Integer value, rounded away from zero (Go ``Quantity.Value()``)."""
        v = self._value
        return math.ceil(v) if v >= 0 else math.floor(v)

    def milli_value(self) -> int:
        """Milli-units, rounded away from zero (Go ``Quantity.MilliValue()``)."""
        v = self._value * 1000
        return math.ceil(v) if v >= 0 else math.floor(v)

    def __add__(self, other: "Quantity") -> "Quantity":
        return Quantity(self._value + Quantity(other)._value)

    def __sub__(self, other: "Quantity") -> "Quantity":
        return Quantity(self._value - Quantity(other)._value)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, (Quantity, int, str, Fraction)) and (
            self._value == Quantity(other)._value  # type: ignore[arg-type]
        )

    def __lt__(self, other: "Quantity") -> bool:
        return self._value < Quantity(other)._value

    def __le__(self, other: "Quantity") -> bool:
        return self._value <= Quantity(other)._value

    def __hash__(self) -> int:
        return hash(self._value)

    def __repr__(self) -> str:
        if self._text is not None:
            return f"Quantity({self._text!r})"
        return f"Quantity({str(self._value)})"

    def __str__(self) -> str:
        return self._text if self._text is not None else str(self._value)


def _parse(text: str) -> Fraction:
    m = _QUANTITY_RE.match(text.strip())
    if not m:
        raise ValueError(f"invalid quantity: {text!r}")
    num = Fraction(m.group("num"))
    if m.group("exp"):
        num *= Fraction(10) ** int(m.group("exp"))
    num *= _SUFFIXES[m.group("suffix") or ""]
    if m.group("sign") == "-":
        num = -num
    return num


def parse_quantity(text: "str | int | float") -> Quantity:
    if isinstance(text, float):
        return Quantity(Fraction(str(text)))
    return Quantity(text)


def cpu_to_millis(text: "str | int | float") -> int:
    """CPU quantity -> millicores (the scheduler's CPU unit)."""
    if isinstance(text, str):
        return _cpu_millis_cached(text)
    return parse_quantity(text).milli_value()


def to_int_value(text: "str | int | float") -> int:
    """Memory/storage/scalar quantity -> integer units (bytes for memory)."""
    if isinstance(text, str):
        return _int_value_cached(text)
    return parse_quantity(text).value()


# Quantity strings repeat massively across objects ("50m", "256Gi", node
# sizes): the Fraction parse dominated scheduling-unit construction at
# 10k-object batches, and the string -> int mappings are pure.
@functools.lru_cache(maxsize=16384)
def _cpu_millis_cached(text: str) -> int:
    return parse_quantity(text).milli_value()


@functools.lru_cache(maxsize=16384)
def _int_value_cached(text: str) -> int:
    return parse_quantity(text).value()
