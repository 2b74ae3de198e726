"""Device ops: the CUDA kernels of the counting path (pack, sort_runs)
and the counting pipeline built on them (count), the resident count
table (device_table), and the batched catalog's device programs: the
walk (batch_walk), the Dijkstra sweeps (pathgraph) and NNLS (nnls).
Each kernel wrapper keeps a plain torch version beside it, which it
takes only for CPU tensors."""
