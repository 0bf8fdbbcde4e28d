"""queasars_tpu_torch: the PyTorch/CUDA port of queasars_tpu.

The JAX package ``queasars_tpu`` is the reference; this package mirrors its
module layout and tensor contracts, runs on an NVIDIA H100 through CUDA
kernels written by hand for Hopper (``csrc/``), and on the CPU through the
kernels' plain PyTorch versions.  It imports ``torch``, numpy and the
standard library only.

Ported so far: every solver of the JAX package on one device -- EVQE and
MoG-VQE (exact or shot-sampled, diagonal or general operators) on the JAX
package's two kernel routes, the kron-fold route (the default) and the slot
route (``QUEASARS_MXU=0``); NFT, SPSA, COBYLA and gradient descent; QNEAT,
ADAPT-VQE and QAOA; the JSSP, spin-chain and QUBO-family problem encoders;
external evaluation backends and black-box bitstring objectives; the JSON
and OpenQASM codecs, full-state checkpoint and resume, profiling, plots and
the command line (``python -m queasars_tpu_torch solve``); the population
mesh and its multi-process runtime (``parallel``); amplitude sharding, one
statevector split over a (pop, amp) mesh (``sim/sharded_evaluator.py``),
for EVQE, MoG-VQE, QNEAT, QAOA and the command line.
"""

__version__ = "0.1.0"
