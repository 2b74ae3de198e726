"""Valid windows counted by every count of the window (each count's
``total``), over the time from the first count's start to the last
count's end."""


def read(obs):
    calls = obs["calls"]
    if obs["kind"] != "count" or not calls:
        return None
    return sum(w for _, _, w in calls) / ((calls[-1][1] - calls[0][0]) / 1e9)
