"""Host seconds inside the count's input (the file read and parsed,
batches joined and cut into chunks), as a share of the seconds of the
traced counts: the harness's "input" spans round every step of
``ops.count.chunk_stream``, in every attempt of a count, the ones a
capacity retry throws away included."""


def read(obs):
    spans = (obs.get("trace") or {}).get("span_s") or {}
    calls = obs.get("calls")
    if not spans.get("input") or not calls:
        return None
    return 100 * spans["input"] / (sum(e - s for s, e, _ in calls) / 1e9)
