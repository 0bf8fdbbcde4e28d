"""Host utilities of the port: seed derivation, device resolution, the CUDA
kernel library loader and the validated bitstring objective."""

from queasars_tpu_torch.utils.bitstring_evaluation import BitstringEvaluator

__all__ = ["BitstringEvaluator"]
