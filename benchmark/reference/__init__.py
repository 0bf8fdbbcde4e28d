"""The plain reference the benchmark holds the port against: plain PyTorch
in any dtype, importing nothing of the port and nothing of JAX."""
