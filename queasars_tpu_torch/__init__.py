"""queasars_tpu_torch: the PyTorch/CUDA port of queasars_tpu.

The JAX package ``queasars_tpu`` is the reference; this package mirrors its
module layout and tensor contracts, runs on an NVIDIA H100 through CUDA
kernels written by hand for Hopper (``csrc/``), and on the CPU through the
kernels' plain PyTorch versions.  It imports ``torch``, numpy and the
standard library only.

Ported so far: the exact-estimator EVQE solve of diagonal (JSSP)
Hamiltonians on the JAX package's two kernel routes, the kron-fold route
(the default; four fold kernels) and the slot route (``QUEASARS_MXU=0``;
four slot kernels) — see ROADMAP.md for what follows.
"""

__version__ = "0.1.0"
