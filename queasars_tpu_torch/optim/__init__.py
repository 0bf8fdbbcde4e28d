"""Batched parameter optimizers: NFT and SPSA (with its termination checker)
in population lock-step over the fold and slot kernels, Adam/SGD through
autograd of the plain engines, and COBYLA per individual."""

from queasars_tpu_torch.optim.nft import BatchedNFT, NFTConfig
from queasars_tpu_torch.optim.spsa import BatchedSPSA, SPSAConfig
from queasars_tpu_torch.optim.cobyla import CobylaConfig, ScipyCobyla
from queasars_tpu_torch.optim.gradient import BatchedGradientDescent, GradientDescentConfig
from queasars_tpu_torch.optim.spsa_termination import SPSATerminationChecker

__all__ = [
    "BatchedNFT",
    "NFTConfig",
    "BatchedSPSA",
    "SPSAConfig",
    "CobylaConfig",
    "ScipyCobyla",
    "BatchedGradientDescent",
    "GradientDescentConfig",
    "SPSATerminationChecker",
]
