"""Share of the traced window in which the card ran no kernel, copy or
fill (torch.profiler's device events), in the catalog cells."""


def read(obs):
    tr = obs.get("trace")
    if not tr or not tr["events"] or obs["kind"] != "catalog":
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
