"""Targets of every run_catalog call of the window, over the time from
the first call's start to the last call's end."""


def read(obs):
    calls = obs["calls"]
    if obs["kind"] != "catalog" or not calls:
        return None
    return sum(w for _, _, w in calls) / ((calls[-1][1] - calls[0][0]) / 1e9)
