"""Optimization problems encoded as Hamiltonians (JSSP so far)."""
