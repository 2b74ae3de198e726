"""torch.cuda.max_memory_allocated() over the window, reset at its
start, in GiB."""


def read(obs):
    peak = obs.get("peak_window_bytes")
    return peak / 2 ** 30 if peak else None
