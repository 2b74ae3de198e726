"""The readers of the card parse on synthetic observations:
``count.read_pct`` (the ``count.read`` span's share of the counts'
seconds) and ``count.card_parse_pct`` (the text parsed on the card over
the text read). Each gives a value where the counts report the card
path's span or bytes, and None where none does (a program that parses
on the host, or a count of held batches)."""

import pytest

from test_kmbench_arithmetic import calls, reader


def count_obs(span_s, nbytes=None):
    stats = [{"total": 9, "span_s": dict(span_s)} for _ in range(2)]
    if nbytes is not None:
        for s, (read, parsed) in zip(stats, nbytes):
            s.update(input_bytes=read, card_parsed_bytes=parsed)
    return {"kind": "count", "calls": calls([4.0, 4.0]),
            "count_stats": stats}


def test_read_share():
    # each count spends 1 s reading: 2 s of 8 s of counts
    obs = count_obs({"count.read": 1.0, "count.upload": 0.1})
    assert reader("count.read_pct")(obs) == pytest.approx(25.0)
    # the host parser's spans: nothing to read
    assert reader("count.read_pct")(
        count_obs({"count.input": 3.0, "count.upload": 1.0})) is None
    other = count_obs({"count.read": 1.0})
    other["kind"] = "catalog"
    assert reader("count.read_pct")(other) is None


@pytest.mark.parametrize("nbytes, want", [
    (((100, 100), (50, 50)), 100.0),
    (((100, 100), (100, 0)), 50.0),
    (((0, 0), (0, 0)), None),
    (None, None),
])
def test_card_parse_share(nbytes, want):
    got = reader("count.card_parse_pct")(count_obs({"count.read": 1.0},
                                                   nbytes))
    assert got == (None if want is None else pytest.approx(want))
