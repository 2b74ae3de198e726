"""Natural sort keys with per-field descending order.

Behavioral contract (shared with km/utils/common.py:95-116): each input
string is split into alternating text/number runs, digit runs compare as
ints, text lowercased; fields whose index appears in ``rev_ix`` compare in
descending order. Used to order report rows: 'vs_ref' rows before
'cluster ...' rows, then by query, variant position, type, min coverage.
"""

from __future__ import annotations

import re

_SPLIT = re.compile(r"([0-9]+)")


class _Desc:
    """Wrapper inverting comparison order."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __eq__(self, other):
        return other.obj == self.obj

    def __lt__(self, other):
        return self.obj > other.obj


def _alphanum(s: str):
    return [int(tok) if tok.isdigit() else tok.lower()
            for tok in _SPLIT.split(s)]


def natsortkey(*fields: str, rev_ix=()):
    """Sort key over multiple string fields; ``rev_ix`` lists descending
    field positions."""
    return tuple(
        _Desc(_alphanum(f)) if i in rev_ix else _alphanum(f)
        for i, f in enumerate(fields)
    )
