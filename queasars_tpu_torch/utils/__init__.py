"""Host utilities of the port: seed derivation, device resolution, the CUDA
kernel library loader, the validated bitstring objective and profiler
trace capture."""

from queasars_tpu_torch.utils.bitstring_evaluation import BitstringEvaluator
from queasars_tpu_torch.utils.profiling import annotate, trace

__all__ = ["BitstringEvaluator", "trace", "annotate"]
