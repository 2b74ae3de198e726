"""Device ops: the two CUDA kernels of the counting path (pack,
sort_runs), the counting pipeline built on them (count), and the
resident count table (device_table). Each kernel wrapper keeps a plain
torch version beside it, which it takes only for CPU tensors."""
