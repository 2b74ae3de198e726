"""FASTA target parsing with km's header attribute grammar.

Headers look like ``>chr5:171387949-171388012 | name=NPM1_ex10 | strand=+``;
the leading location token is rewritten to a ``location=`` attribute and
the remaining ``key=value`` fields are split on ``|``
(reference: km/utils/common.py:25-45, km/tools/find_report.py:48-76).
"""

from __future__ import annotations

import os
from typing import Iterator


def iter_fasta(path: str) -> Iterator[tuple[str, str]]:
    """Yield (header, sequence) pairs; header keeps its leading '>'."""
    header = None
    chunks: list[str] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line
                chunks = []
            else:
                chunks.append(line)
    if header is not None:
        yield header, "".join(chunks)


def parse_header_attrs(header: str) -> dict[str, str]:
    """``>loc | k=v | ...`` -> {'location': loc, k: v, ...}."""
    attrs: dict[str, str] = {}
    for part in header.replace(">", "location=", 1).split("|"):
        pieces = part.split("=")
        attrs[pieces[0].strip()] = pieces[1].strip()
    return attrs


def read_target(path: str) -> tuple[list[str], list[dict[str, str]]]:
    """All entries of a target file: uppercased sequences + attr dicts."""
    seqs: list[str] = []
    attrs: list[dict[str, str]] = []
    for header, seq in iter_fasta(path):
        attrs.append(parse_header_attrs(header))
        seqs.append(seq.upper())
    return seqs, attrs


def expand_target_files(args: list[str]) -> list[str]:
    """File-or-directory expansion for target arguments
    (reference: km/utils/common.py:7-22)."""
    if len(args) > 1:
        return list(args)
    if len(args) == 1 and os.path.isdir(args[0]):
        return [os.path.join(args[0], f) for f in os.listdir(args[0])]
    return list(args)
