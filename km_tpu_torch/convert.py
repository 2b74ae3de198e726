"""km_tpu state -> km_tpu_torch state, from numpy arrays.

This system has no model weights: its state is the count table and the
streaming accumulator. These functions take km_tpu's device arrays (read
back with ``np.asarray``) and build the port's equivalents, so that both
packages can be fed the same state. A km_tpu host CountTable goes
through ``DeviceCountTable.from_host``.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import SENTINEL, resolve_device, split_to_i64
from .ops.device_table import DeviceCountTable


def accumulator_from_jax(acc_hi, acc_lo, acc_cnt, device="cpu"):
    """km_tpu stream accumulator (hi, lo uint32 keys with all-ones
    padding, int32 counts) -> the port's (int64 keys with SENTINEL
    padding, int64 counts) on ``device``."""
    dev = resolve_device(device)
    keys = split_to_i64(np.asarray(acc_hi), np.asarray(acc_lo))
    cnt = np.asarray(acc_cnt).astype(np.int64)
    return (torch.from_numpy(keys).to(dev), torch.from_numpy(cnt).to(dev))


def table_from_jax(keys_hi, keys_lo, counts, k: int, canonical: bool,
                   name: str = "", device="cpu") -> DeviceCountTable:
    """km_tpu DeviceCountTable arrays (sorted split keys padded with the
    all-ones pair, int32 counts) -> the port's DeviceCountTable; the
    padding entries are dropped."""
    keys = split_to_i64(np.asarray(keys_hi), np.asarray(keys_lo))
    real = keys != SENTINEL
    return DeviceCountTable(keys[real].astype(np.uint64),
                            np.asarray(counts)[real], k, canonical,
                            name=name, device=device)

