"""Hierarchical seed derivation.

The whole framework's determinism story: one master ``random.Random`` per
solver, children seeded via :func:`new_random_seed` in a fixed call order
(reference: queasars/utility/random.py:7-15).  Structural randomness
(genome shapes, selection draws) stays on the host with Python ``Random``,
exactly as the reference and the JAX package do.
"""

from __future__ import annotations

from random import Random


def new_random_seed(random_generator: Random) -> int:
    """Draw a new integer seed in [0, 2147483647].

    Reference: queasars/utility/random.py:7-15 (same range, same single
    ``randint`` call, so seed-derivation chains match the reference).
    """
    return random_generator.randint(0, 2147483647)
