"""The count's four kernels (K1 pack, K2 sort_runs, M1 chunk_runs, M2
merge_accum) as a whole: the least time their launches of the window
could take, bytes over the card's memory bandwidth, over their device
time in the trace. Bytes come from the sizes each launch was handed and
returned (kmbench/roofline.py); time from the device functions each
launches."""

import sys

from kmbench import roofline


def read(obs):
    tr = obs.get("trace")
    if not tr or not tr["events"] or not tr.get("kernel_bytes") \
            or not tr.get("hbm_bytes_per_s"):
        return None
    seconds = 0.0
    for name, (sec, _n) in tr["kernels"].items():
        if roofline.group_of(name):
            seconds += sec
    moved = sum(b for b, _ in tr["kernel_bytes"].values())
    if not seconds or not moved:
        return None
    launched = {g: n for g, (_, n) in tr["kernel_bytes"].items()}
    sys.stderr.write("roofline: launches %s\n" % launched)
    return 100 * moved / tr["hbm_bytes_per_s"] / seconds
