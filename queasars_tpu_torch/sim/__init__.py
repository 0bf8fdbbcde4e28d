"""Statevector engine, slot kernels, expectations and evaluators."""
