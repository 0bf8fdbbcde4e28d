"""Statevector engine, slot and fold kernels, expectations and evaluators."""
