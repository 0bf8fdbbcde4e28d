"""Packed-bitmask Pauli-sum algebra.

Replaces the reference's dependency on Qiskit's ``SparsePauliOp`` (used for
all Hamiltonian construction, e.g.
queasars/job_shop_scheduling/domain_wall_hamiltonian_encoder.py:223-229 and
queasars/utility/domain_wall_variables.py:93-113).  A ``PauliSum`` stores K
terms as a complex coefficient vector plus two ``uint64`` bitmask matrices
(Z-mask and X-mask, one row per term, ``ceil(n/64)`` words per row), which is
a representation that suits parity/popcount arithmetic over
packed words instead of string labels.

Conventions (chosen to match Qiskit/the reference bit ordering so that the
JSSP encoder reproduces reference energies, see
queasars/utility/pauli_strings.py:39 — qubit index counts from the *right* of
the label string; integer basis-state ``i`` has qubit ``q`` in state
``(i >> q) & 1``):

- bit ``q`` of a mask word row refers to qubit ``q``,
- a term is stored as exactly ``coeff * Z^z X^x`` (the coefficient absorbs
  all phases; per-qubit labels map as I=(0,0), X=(0,1), Z=(1,0) and
  Y = -i.Z.X = (1,1) with a ``-i`` folded into the coefficient),
- ``Z^z`` acting on ``|i>`` contributes ``(-1)^{popcount(z AND i)}``.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Union

import numpy as np

Scalar = Union[int, float, complex]

_WORD_BITS = 64


def _n_words(n_qubits: int) -> int:
    return max(1, -(-n_qubits // _WORD_BITS))


def _masks_from_qubits(qubits: Iterable[int], n_qubits: int) -> np.ndarray:
    row = np.zeros(_n_words(n_qubits), dtype=np.uint64)
    for q in qubits:
        if not 0 <= q < n_qubits:
            raise ValueError(f"qubit index {q} out of range for {n_qubits} qubits")
        row[q // _WORD_BITS] |= np.uint64(1) << np.uint64(q % _WORD_BITS)
    return row


def _popcount_rows(masks: np.ndarray) -> np.ndarray:
    """Per-row popcount over packed uint64 words."""
    return np.bitwise_count(masks).sum(axis=-1).astype(np.int64)


class PauliSum:
    """A weighted sum of Pauli strings over ``n_qubits`` qubits.

    Immutable by convention: all operations return new instances.
    """

    __slots__ = ("n_qubits", "coeffs", "z", "x")

    def __init__(
        self,
        n_qubits: int,
        coeffs: np.ndarray,
        z: np.ndarray,
        x: np.ndarray,
    ):
        if n_qubits < 1:
            raise ValueError("A PauliSum needs at least one qubit!")
        coeffs = np.atleast_1d(np.asarray(coeffs, dtype=np.complex128))
        z = np.atleast_2d(np.asarray(z, dtype=np.uint64))
        x = np.atleast_2d(np.asarray(x, dtype=np.uint64))
        if not (coeffs.shape[0] == z.shape[0] == x.shape[0]):
            raise ValueError("coeffs, z and x must have matching term counts")
        if z.shape[1] != _n_words(n_qubits) or x.shape[1] != _n_words(n_qubits):
            raise ValueError("mask word count does not match n_qubits")
        self.n_qubits = n_qubits
        self.coeffs = coeffs
        self.z = z
        self.x = x

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    @staticmethod
    def identity(n_qubits: int, coeff: Scalar = 1.0) -> "PauliSum":
        w = _n_words(n_qubits)
        return PauliSum(
            n_qubits,
            np.array([coeff], dtype=np.complex128),
            np.zeros((1, w), dtype=np.uint64),
            np.zeros((1, w), dtype=np.uint64),
        )

    @staticmethod
    def from_label(label: str, coeff: Scalar = 1.0) -> "PauliSum":
        """Build a single-term PauliSum from a Qiskit-style label string.

        The rightmost character of the label is qubit 0 (reference
        convention: queasars/utility/pauli_strings.py:39).
        """
        n = len(label)
        z_qubits, x_qubits, phase_ys = [], [], 0
        for pos, ch in enumerate(label):
            q = n - 1 - pos
            if ch in ("Z", "Y"):
                z_qubits.append(q)
            if ch in ("X", "Y"):
                x_qubits.append(q)
            if ch == "Y":
                phase_ys += 1
            if ch not in "IXYZ":
                raise ValueError(f"invalid Pauli label character {ch!r}")
        c = complex(coeff) * (-1j) ** (phase_ys % 4)
        return PauliSum(
            n,
            np.array([c], dtype=np.complex128),
            _masks_from_qubits(z_qubits, n)[None, :],
            _masks_from_qubits(x_qubits, n)[None, :],
        )

    @staticmethod
    def from_sparse_list(
        terms: Sequence[tuple[str, Sequence[int], Scalar]], n_qubits: int
    ) -> "PauliSum":
        """Build from ``[(pauli_chars, qubit_indices, coeff), ...]``."""
        parts = []
        for chars, qubits, coeff in terms:
            label = ["I"] * n_qubits
            for ch, q in zip(chars, qubits):
                label[n_qubits - 1 - q] = ch
            parts.append(PauliSum.from_label("".join(label), coeff))
        if not parts:
            return PauliSum.identity(n_qubits, 0.0)
        return PauliSum.sum(parts)

    @staticmethod
    def sum(ops: Sequence["PauliSum"]) -> "PauliSum":
        """Concatenate-and-simplify a list of PauliSums.

        Mirrors ``SparsePauliOp.sum`` as used at
        queasars/job_shop_scheduling/domain_wall_hamiltonian_encoder.py:224.
        """
        if len(ops) == 0:
            raise ValueError("cannot sum an empty list of PauliSums")
        n = ops[0].n_qubits
        for op in ops:
            if op.n_qubits != n:
                raise ValueError("all summands must act on the same qubit count")
        out = PauliSum(
            n,
            np.concatenate([op.coeffs for op in ops]),
            np.concatenate([op.z for op in ops]),
            np.concatenate([op.x for op in ops]),
        )
        return out.simplify()

    # ------------------------------------------------------------------
    # algebra
    # ------------------------------------------------------------------

    @property
    def n_terms(self) -> int:
        return int(self.coeffs.shape[0])

    def __add__(self, other: "PauliSum") -> "PauliSum":
        return PauliSum.sum([self, other])

    def __sub__(self, other: "PauliSum") -> "PauliSum":
        return PauliSum.sum([self, other * (-1.0)])

    def __mul__(self, scalar: Scalar) -> "PauliSum":
        return PauliSum(self.n_qubits, self.coeffs * complex(scalar), self.z, self.x)

    __rmul__ = __mul__

    def compose(self, other: "PauliSum") -> "PauliSum":
        """Operator product ``self @ other`` (self applied after other).

        For the diagonal (Z-only) terms produced by the JSSP encoder this is
        commutative, matching the reference's use of
        ``SparsePauliOp.compose`` at domain_wall_hamiltonian_encoder.py:272.

        General case: ``(Z^za X^xa)(Z^zb X^xb) =
        (-1)^{|xa AND zb|} Z^(za XOR zb) X^(xa XOR xb)`` — because the
        coefficient stores all phases, no extra Y bookkeeping is needed.
        """
        if self.n_qubits != other.n_qubits:
            raise ValueError("qubit counts must match for compose")
        ka, kb = self.n_terms, other.n_terms
        za = np.repeat(self.z, kb, axis=0)
        xa = np.repeat(self.x, kb, axis=0)
        ca = np.repeat(self.coeffs, kb)
        zb = np.tile(other.z, (ka, 1))
        xb = np.tile(other.x, (ka, 1))
        cb = np.tile(other.coeffs, ka)

        anticommute = _popcount_rows(xa & zb)
        sign = np.where(anticommute % 2 == 0, 1.0, -1.0)
        coeffs = ca * cb * sign
        return PauliSum(self.n_qubits, coeffs, za ^ zb, xa ^ xb).simplify()

    def __matmul__(self, other: "PauliSum") -> "PauliSum":
        return self.compose(other)

    def simplify(self, atol: float = 0.0) -> "PauliSum":
        """Merge duplicate (z, x) terms; drop terms with |coeff| <= atol."""
        keys = np.concatenate([self.z, self.x], axis=1)
        uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
        coeffs = np.zeros(uniq.shape[0], dtype=np.complex128)
        np.add.at(coeffs, inverse.ravel(), self.coeffs)
        w = self.z.shape[1]
        keep = np.abs(coeffs) > atol
        if not np.any(keep):
            # keep one zero identity term so the op stays well-formed
            return PauliSum.identity(self.n_qubits, 0.0)
        return PauliSum(self.n_qubits, coeffs[keep], uniq[keep, :w], uniq[keep, w:])

    # ------------------------------------------------------------------
    # predicates / conversions
    # ------------------------------------------------------------------

    @property
    def is_diagonal(self) -> bool:
        """True if every term is Z/I only (x-mask empty)."""
        return not np.any(self.x)

    def z_masks_lo64(self) -> np.ndarray:
        """First (low) mask word per term as uint64 — valid for n<=64 qubits.

        This is the form handed to the device kernels (uint32 for n<=32).
        """
        return self.z[:, 0].copy()

    def to_labels(self) -> list[tuple[str, complex]]:
        """Qiskit-convention ``(label, coefficient)`` pairs per term.

        The inverse of :meth:`from_label`: per-qubit masks map back to
        I/X/Y/Z characters (rightmost character = qubit 0, the reference
        convention — queasars/utility/pauli_strings.py:39), and the
        ``(-i)^{n_Y}`` phase that storage folds into the coefficient is
        unfolded, so ``qiskit.quantum_info.SparsePauliOp.from_list``
        reconstructs an operator with identical matrix elements (the
        interop-bundle export path, examples/export_to_qiskit.py).
        Limited to n <= 64 (single mask word).
        """
        if self.n_qubits > 64:
            raise NotImplementedError("label export limited to n<=64 qubits")
        out = []
        for k in range(self.n_terms):
            z = int(self.z[k, 0])
            x = int(self.x[k, 0])
            chars = []
            n_y = 0
            for pos in range(self.n_qubits - 1, -1, -1):
                zb, xb = (z >> pos) & 1, (x >> pos) & 1
                if zb and xb:
                    chars.append("Y")
                    n_y += 1
                elif zb:
                    chars.append("Z")
                elif xb:
                    chars.append("X")
                else:
                    chars.append("I")
            coeff = complex(self.coeffs[k]) * (1j) ** (n_y % 4)
            out.append(("".join(chars), coeff))
        return out

    def to_dense_matrix(self) -> np.ndarray:
        """Dense 2^n x 2^n matrix (test oracle only; small n)."""
        n = self.n_qubits
        dim = 1 << n
        idx = np.arange(dim, dtype=np.uint64)
        out = np.zeros((dim, dim), dtype=np.complex128)
        for k in range(self.n_terms):
            z = int(self.z[k, 0]) if n <= 64 else None
            x = int(self.x[k, 0]) if n <= 64 else None
            if z is None:
                raise NotImplementedError("dense conversion limited to n<=64")
            cols = idx
            rows = idx ^ np.uint64(x)
            # (Z^z X^x)|i> = (-1)^{|z & (i^x)|} |i^x>  — Z acts after X flips.
            signs = (-1.0) ** np.bitwise_count(np.uint64(z) & rows)
            out[rows, cols] += self.coeffs[k] * signs
        return out

    def equiv(self, other: "PauliSum", atol: float = 1e-10) -> bool:
        diff = PauliSum.sum([self, other * (-1.0)]).simplify(atol=atol)
        return diff.n_terms == 1 and abs(diff.coeffs[0]) <= atol

    def __repr__(self) -> str:
        return (
            f"PauliSum(n_qubits={self.n_qubits}, n_terms={self.n_terms}, "
            f"diagonal={self.is_diagonal})"
        )
