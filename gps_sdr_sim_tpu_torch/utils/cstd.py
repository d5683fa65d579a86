"""Small helpers that replicate C standard-library semantics.

The host layer must reproduce the C oracle's arithmetic exactly; Python's
round() (banker's rounding) and float() (strict parsing) differ from C's
round() (half away from zero) and atof() (lenient prefix parsing), so we
provide faithful equivalents.
"""

from __future__ import annotations

import re

import numpy as np

_FLOAT_RE = re.compile(r"^[ \t\n\r\f\v]*([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)")
_INT_RE = re.compile(r"^[ \t\n\r\f\v]*([+-]?\d+)")


def c_round(x):
    """C round(): round half away from zero. Works on scalars and arrays."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def c_atof(s: str) -> float:
    """C atof(): parse the longest valid numeric prefix, 0.0 on failure."""
    m = _FLOAT_RE.match(s)
    if not m:
        return 0.0
    return float(m.group(1))


def c_atoi(s: str) -> int:
    """C atoi(): parse the longest valid integer prefix, 0 on failure."""
    m = _INT_RE.match(s)
    if not m:
        return 0
    return int(m.group(1))


def c_strtod(s: str):
    """C strtod(): (value, ok) — ok is False when no conversion happened."""
    m = _FLOAT_RE.match(s)
    if not m:
        return 0.0, False
    return float(m.group(1)), True


def c_sscanf_doubles(s: str, n: int, sep: str = ","):
    """sscanf(s, "%lf<sep>%lf<sep>...") with n conversions.

    Returns the list of successfully converted values (length <= n); like
    sscanf, conversion stops at the first failure or missing separator,
    leaving later fields untouched in the caller.
    """
    vals = []
    rest = s
    for k in range(n):
        if k > 0:
            if not rest.startswith(sep):
                break
            rest = rest[len(sep):]
        m = _FLOAT_RE.match(rest)
        if not m:
            break
        vals.append(float(m.group(1)))
        rest = rest[m.end():]
    return vals
