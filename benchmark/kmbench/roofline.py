"""The count kernels' bytes, the card's peaks, and kernel names.

Bytes are those of the port's kernel tables (PERF.md): every input byte
read once and every output byte written once, from the sizes a launch
was handed and returned. The bound of a launch is its bytes over the
card's memory bandwidth: these kernels do no arithmetic to speak of.
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM (80 GB HBM3), at its 700 W limit
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# each of the count's kernels, by the device functions it launches
KERNELS = {
    "K1 pack": ("pack_windows_kernel",),
    "K2 sort_runs": ("sort_runs_kernel",),
    "M1 chunk_runs": ("sample_sort_kernel", "sample_rank_kernel",
                      "compact_kernel", "bucket_kernel"),
    "M2 merge_accum": ("merge_cuts_kernel", "merge_accum_kernel"),
}


def pack_bytes(windows: int) -> int:
    """K1: a code and a flag in, an int64 key out, per position."""
    return windows * (1 + 1 + 8)


def sort_runs_bytes(keys: int) -> int:
    """K2: a key in; the key and an int32 run length out."""
    return keys * (8 + 8 + 4)


def chunk_runs_bytes(windows: int, runs: int) -> int:
    """M1: a key and a run length in per window; a key and an int64
    count out per run."""
    return 12 * windows + 16 * runs


def merge_accum_bytes(live_in: int, merged_out: int) -> int:
    """M2: a key and a count in per live record (accumulator and runs);
    a key and a count out per merged key."""
    return 16 * live_in + 16 * merged_out


def kernel_name(raw: str) -> str:
    """A device function's plain name: no return type, namespace,
    template arguments or parameters."""
    name = raw.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    if name.startswith("void "):
        name = name[5:]
    return name.split("::")[-1].strip()


def group_of(name: str) -> str | None:
    for group, kernels in KERNELS.items():
        if name in kernels:
            return group
    return None
