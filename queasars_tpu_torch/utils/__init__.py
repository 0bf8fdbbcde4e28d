"""Host utilities of the port: seed derivation, device resolution and the
CUDA kernel library loader."""
