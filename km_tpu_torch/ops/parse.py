"""P1 ``parse_fastq``: FASTQ text on the device -> one chunk's codes and
flags, as the stream count's K1 takes them.

``parse_fastq`` launches ``csrc/parse_fastq.cu`` for CUDA tensors and runs
``parse_fastq_plain`` for CPU tensors. It replaces no TPU kernel: km_tpu
parses on the host (``native/kmio.cpp::km_parse_fastq``) and uploads codes
and flags. The port's stream count on a card uploads the text of whole
records instead (``ops/count.py::count_fastq_device_stream``), so the
host's input is one read into pinned memory. The bound is bytes: the text
read once and 2 B a position written (csrc's design note).

The output equals ``km_parse_fastq``'s on every record, padded with
invalid positions to ``chunk``: codes 0..3 and flags for A, C, G, T in
either case, invalid for anything else and for a base whose quality byte
is under ``min_quality``, one invalid separator after each read. Records
are read by lines: a line starting ``@``, the sequence, a line starting
``+``, a quality line as long as the sequence, each ended by a newline.
Text that breaks this, or that holds more than ``chunk`` positions, sets
``bad`` (int64 [1], on the text's device) to 1 and is never counted; the
caller reads ``bad`` when it next waits. Two records the host parser takes
are broken here: a third line that does not start with ``+``, and a
quality line not ended by a newline before the next record (the host's
trailing-record and file-end handling is the caller's, see ops/count.py).
"""

from __future__ import annotations

import torch

from .. import _build

NEWLINE, AT, PLUS = ord("\n"), ord("@"), ord("+")

# base byte -> code; 255 is invalid (native/kmio.cpp's table)
_CODES = torch.full((256,), 255, dtype=torch.uint8)
for _i, _bases in enumerate(("Aa", "Cc", "Gg", "Tt")):
    for _b in _bases:
        _CODES[ord(_b)] = _i


def _qmin(min_quality) -> int:
    """The least quality byte of a valid base, -1 for none (host parser's
    ``-Q`` reading)."""
    return ord(min_quality) if min_quality else -1


def _check(text: torch.Tensor, chunk: int, bad: torch.Tensor) -> None:
    if text.dtype != torch.uint8 or text.dim() != 1 \
            or not text.is_contiguous():
        raise ValueError("text must be a contiguous 1-D uint8 tensor")
    if text.numel() > 1 << 30:
        raise ValueError("text of %d bytes: at most 2^30" % text.numel())
    if chunk <= 0:
        raise ValueError("chunk must be > 0")
    if bad.dtype != torch.int64 or bad.shape != (1,):
        raise ValueError("bad must be an int64 tensor of one element")
    if bad.device != text.device:
        raise ValueError("text on %s but bad on %s" % (text.device,
                                                      bad.device))


def parse_fastq(text: torch.Tensor, chunk: int, min_quality, bad: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """text (uint8 [n]: whole FASTQ records) -> (codes uint8 [chunk], valid
    bool [chunk]) on its device; sets bad[0] to 1 where the text is not
    whole records or does not fit ``chunk``. ``min_quality``: a one-byte
    string or None."""
    _check(text, chunk, bad)
    dev = text.device
    if dev.type == "cpu":
        return parse_fastq_plain(text, chunk, min_quality, bad)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    codes = torch.empty(chunk, dtype=torch.uint8, device=dev)
    valid = torch.empty(chunk, dtype=torch.bool, device=dev)
    n = text.numel()
    if n == 0:
        codes.zero_()
        valid.zero_()
        return codes, valid
    lib = _build.lib()
    scratch = torch.empty(lib.km_parse_fastq_scratch(n), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        code = lib.km_parse_fastq_device(
            text.data_ptr(), n, _qmin(min_quality), chunk, codes.data_ptr(),
            valid.data_ptr(), bad.data_ptr(), scratch.data_ptr(),
            scratch.numel(), _build.stream_ptr(dev))
    _build.check(code, "parse_fastq")
    parse_fastq.launches += 1
    return codes, valid


parse_fastq.launches = 0


def parse_fastq_plain(text: torch.Tensor, chunk: int, min_quality,
                      bad: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain torch version, its steps over the whole text
    where the kernel takes them a tile at a time: the newlines' offsets, a
    record every fourth, its structure checked, its positions (sequence
    length and the separator) scanned to output offsets, and its bases
    coded into them; a broken record or one past the chunk writes
    nothing."""
    dev = text.device
    codes = torch.zeros(chunk, dtype=torch.uint8, device=dev)
    valid = torch.zeros(chunk, dtype=torch.bool, device=dev)
    n = text.numel()
    if n == 0:
        return codes, valid
    ends = torch.nonzero(text == NEWLINE).flatten()
    lines = ends.numel()
    broken = lines % 4 != 0 or int(text[-1]) != NEWLINE
    e = ends[:lines - lines % 4].view(-1, 4)
    head = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      e[:-1, 3] + 1])[:e.shape[0]]
    seq, plus, qual = e[:, 0] + 1, e[:, 1] + 1, e[:, 2] + 1
    length = e[:, 1] - seq
    ok = (text[head] == AT) & (text[plus] == PLUS) & (e[:, 3] - qual == length)
    positions = torch.where(ok, length + 1, torch.zeros_like(length))
    offsets = torch.cumsum(positions, 0) - positions
    total = int(positions.sum())
    if broken or not bool(ok.all()) or total > chunk:
        bad.fill_(1)
    write = ok & (offsets + positions <= chunk)
    length, seq, qual, offsets = (t[write] for t in (length, seq, qual,
                                                      offsets))
    rec = torch.repeat_interleave(torch.arange(length.numel(), device=dev),
                                  length)
    within = torch.arange(rec.numel(), device=dev) - (
        torch.cumsum(length, 0) - length)[rec]
    c = _CODES.to(dev)[text[seq[rec] + within].long()]
    good = (c != 255) & (text[qual[rec] + within].to(torch.int64)
                         >= _qmin(min_quality))
    at = offsets[rec] + within
    codes[at] = torch.where(good, c, torch.zeros_like(c))
    valid[at] = good
    return codes, valid
