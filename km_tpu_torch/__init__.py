"""km_tpu_torch — the PyTorch/CUDA port of km_tpu, for one NVIDIA H100.

The slice ported so far is the user's whole counting-to-report flow:
reads are counted on the card (hand-written CUDA kernels: the window
pack and the chunk sort with run detection), the count table stays
resident on the card, and ``find_mutation --batch`` runs the walk of
every target, the Dijkstra sweeps and the NNLS refinement there;
``find_report`` is km_tpu's own.

km's semantics live in km_tpu's host modules (io, models, the host half
of ops.count, tools.find_report), which import no JAX; this package
imports them and never imports ``jax``.
"""

__version__ = "0.1.0"
