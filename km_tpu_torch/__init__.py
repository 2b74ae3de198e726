"""km_tpu_torch — the PyTorch/CUDA port of km_tpu, for one NVIDIA H100.

The slice ported so far is the user's whole counting-to-report flow:
reads are counted on the card (hand-written CUDA kernels: the window
pack and the chunk sort with run detection), the count table stays
resident on the card, and ``find_mutation --batch`` runs the walk of
every target, the Dijkstra sweeps and the NNLS refinement there;
``find_report`` reformats the rows.

The package stands alone: km's semantics on the host (io, native,
models, the host half of ops.count, tools.find_report) are its own
numpy copies of km_tpu's modules, held equal to them by the CPU tests.
Nothing here imports ``km_tpu`` or ``jax``.
"""

__version__ = "0.1.0"
