"""QUBO / integer-program to Ising-Hamiltonian encoding.

Counterpart of ``queasars_tpu/problems/qubo.py`` (host numpy, unchanged in
arithmetic, so every encoder emits the JAX package's terms in its order).

The reference's example workflows build Hamiltonians with docplex +
qiskit-optimization (``from_docplex_mp`` -> ``IntegerToBinary`` ->
``to_ising``; see reference test/minimum_eigensolvers/evqe/model.py:10-23
and the example notebooks).  This module provides the same pipeline
natively: binary quadratic objectives and bounded-integer variables map
to a diagonal :class:`~queasars_tpu_torch.paulis.PauliSum` plus a constant
offset (dropped from the operator exactly like ``to_ising`` drops it).

Conventions: qubit ``i`` carries binary variable ``x_i``; basis-state bit
``i`` IS ``x_i`` (little-endian, the framework-wide convention), and the
substitution is ``x_i = (1 - z_i) / 2``.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import ceil, log2
from typing import Optional, Sequence

import numpy as np

from queasars_tpu_torch.paulis import PauliSum
from queasars_tpu_torch.paulis.strings import pauli_identity_string, pauli_z_string


def _zz_string(i: int, j: int, n_qubits: int) -> PauliSum:
    label = "".join(
        "Z" if pos in (n_qubits - 1 - i, n_qubits - 1 - j) else "I" for pos in range(n_qubits)
    )
    return PauliSum.from_label(label, 1.0)


def qubo_hamiltonian(
    quadratic: np.ndarray,
    linear: Optional[np.ndarray] = None,
    constant: float = 0.0,
) -> tuple[PauliSum, float]:
    """Ising form of ``min_x  x^T Q x + l . x + c`` over binary ``x``.

    :param quadratic: [n, n] QUBO matrix (symmetrized internally; the
        diagonal contributes linearly since x_i^2 = x_i)
    :param linear: optional [n] linear coefficients
    :param constant: optional constant term
    :return: (diagonal PauliSum WITHOUT the identity term, offset) such
        that objective(x) = <x|H|x> + offset for every basis state
    """
    quadratic = np.asarray(quadratic, dtype=np.float64)
    n = quadratic.shape[0]
    if quadratic.shape != (n, n):
        raise ValueError("quadratic must be a square matrix")
    symmetric = (quadratic + quadratic.T) / 2.0
    lin = np.zeros(n) if linear is None else np.asarray(linear, dtype=np.float64)
    if lin.shape != (n,):
        raise ValueError("linear must have one coefficient per variable")

    # accumulate Ising coefficients in float64 on host (coefficients can
    # be large for penalty formulations; see SURVEY §7 hard parts)
    z_coeffs = np.zeros(n)
    zz_coeffs = np.zeros((n, n))
    offset = float(constant)

    # diagonal Q_ii x_i^2 = Q_ii x_i folds into the linear part
    lin = lin + np.diag(symmetric)
    # x_i = (1 - z_i)/2
    offset += float(lin.sum()) / 2.0
    z_coeffs -= lin / 2.0

    for i in range(n):
        for j in range(i + 1, n):
            q = 2.0 * symmetric[i, j]  # x_i x_j appears twice in x^T Q x
            if q == 0.0:
                continue
            # x_i x_j = (1 - z_i - z_j + z_i z_j)/4
            offset += q / 4.0
            z_coeffs[i] -= q / 4.0
            z_coeffs[j] -= q / 4.0
            zz_coeffs[i, j] += q / 4.0

    terms: list[PauliSum] = []
    for i in range(n):
        if z_coeffs[i] != 0.0:
            terms.append(pauli_z_string(i, n) * float(z_coeffs[i]))
        for j in range(i + 1, n):
            if zz_coeffs[i, j] != 0.0:
                terms.append(_zz_string(i, j, n) * float(zz_coeffs[i, j]))
    if not terms:
        terms.append(pauli_identity_string(n) * 0.0)
    return PauliSum.sum(terms), offset


def decode_qubo_bits(state: int, n_variables: int) -> list[int]:
    """Basis state -> binary variable assignment (bit i = x_i)."""
    return [(state >> i) & 1 for i in range(n_variables)]


def maxcut_hamiltonian(
    n_nodes: int,
    edges: Sequence[tuple[int, int]],
    weights: Optional[Sequence[float]] = None,
) -> tuple[PauliSum, float]:
    """Ising form of (weighted) MaxCut: minimizing the returned operator
    maximizes the cut.

    cut(x) = sum_{(i,j)} w_ij [x_i != x_j]; with x_i = (1 - z_i)/2 this is
    sum w_ij (1 - z_i z_j)/2, so H = sum (w_ij / 2) Z_i Z_j and
    cut = offset + <x|(-H... (precisely: cut(x) = offset - <x|H|x> with
    offset = sum(w)/2 — the returned offset).

    :return: (H, offset) with cut_value(state) = offset - <state|H|state>
    """
    if weights is None:
        weights = [1.0] * len(edges)
    if len(weights) != len(edges):
        raise ValueError("one weight per edge required")
    terms: list[PauliSum] = []
    offset = 0.0
    for (i, j), w in zip(edges, weights):
        if not (0 <= i < n_nodes and 0 <= j < n_nodes) or i == j:
            raise ValueError(f"invalid edge ({i}, {j})")
        terms.append(_zz_string(i, j, n_nodes) * (w / 2.0))
        offset += w / 2.0
    if not terms:
        terms.append(pauli_identity_string(n_nodes) * 0.0)
    return PauliSum.sum(terms), offset


def tsp_hamiltonian(
    distances: np.ndarray,
    penalty: Optional[float] = None,
) -> tuple[PauliSum, float]:
    """Ising form of the (possibly asymmetric) travelling-salesman
    problem in the standard one-hot position encoding: qubit
    ``city * n + position`` carries x_{city, position}.

    Energy = sum_p sum_{i != j} d_ij x_{i,p} x_{j,(p+1) mod n}
           + penalty * sum_i (1 - sum_p x_{i,p})^2
           + penalty * sum_p (1 - sum_i x_{i,p})^2

    so valid tours (every city exactly once, every position filled)
    carry exactly their cyclic tour length, and every constraint
    violation costs at least ``penalty`` above any valid tour
    (default: n * max(d) + 1 > the longest possible tour).

    :param distances: [n, n] matrix, d[i, j] = cost of travelling i -> j
    :return: (H, offset) with tour_length(state) = <state|H|state> + offset
    """
    d = np.asarray(distances, dtype=float)
    if d.ndim != 2 or d.shape[0] != d.shape[1]:
        raise ValueError("distances must be a square matrix")
    n = d.shape[0]
    if n < 2:
        raise ValueError("need at least two cities")
    if penalty is None:
        penalty = float(n * d.max() + 1.0)
    n_vars = n * n
    var = lambda city, pos: city * n + pos
    quadratic = np.zeros((n_vars, n_vars))
    linear = np.zeros(n_vars)
    constant = 0.0
    # tour-length objective
    for p in range(n):
        p_next = (p + 1) % n
        for i in range(n):
            for j in range(n):
                if i != j and d[i, j] != 0.0:
                    quadratic[var(i, p), var(j, p_next)] += d[i, j]
    # one-hot penalties: (1 - sum_k x_k)^2 = 1 - 2 sum x_k + sum x_k
    # + 2 sum_{k<l} x_k x_l   (x^2 = x for binaries)
    groups = [[var(i, p) for p in range(n)] for i in range(n)]  # each city once
    groups += [[var(i, p) for i in range(n)] for p in range(n)]  # each position filled
    for group in groups:
        constant += penalty
        for a_i, k in enumerate(group):
            linear[k] -= penalty
            for l in group[a_i + 1:]:
                quadratic[k, l] += 2.0 * penalty
    return qubo_hamiltonian(quadratic, linear, constant)


def decode_tsp_tour(state: int, n_cities: int) -> Optional[list[int]]:
    """Basis state -> tour (city visited at each position), or None when
    the one-hot constraints are violated."""
    bits = decode_qubo_bits(state, n_cities * n_cities)
    tour: list[Optional[int]] = [None] * n_cities
    for city in range(n_cities):
        positions = [p for p in range(n_cities) if bits[city * n_cities + p]]
        if len(positions) != 1:
            return None
        if tour[positions[0]] is not None:
            return None
        tour[positions[0]] = city
    return tour  # type: ignore[return-value]


def tour_length(tour: Sequence[int], distances: np.ndarray) -> float:
    """Cyclic tour length under the (possibly asymmetric) distances."""
    d = np.asarray(distances, dtype=float)
    return float(
        sum(d[tour[p], tour[(p + 1) % len(tour)]] for p in range(len(tour)))
    )


def graph_coloring_hamiltonian(
    n_nodes: int,
    edges: Sequence[tuple[int, int]],
    n_colors: int,
    penalty: float = 1.0,
    conflict_weight: float = 1.0,
) -> tuple[PauliSum, float]:
    """Ising form of graph coloring in the one-hot encoding: qubit
    ``node * n_colors + color`` carries x_{node, color}.

    Energy = penalty * sum_v (1 - sum_c x_{v,c})^2
           + conflict_weight * sum_{(u,v) in E} sum_c x_{u,c} x_{v,c}

    A proper ``n_colors``-coloring has energy exactly 0; every
    monochromatic edge costs ``conflict_weight``; every broken one-hot
    costs at least ``penalty``.

    :return: (H, offset) with energy(state) = <state|H|state> + offset
    """
    if n_nodes < 1 or n_colors < 1:
        raise ValueError("need at least one node and one color")
    n_vars = n_nodes * n_colors
    var = lambda node, color: node * n_colors + color
    quadratic = np.zeros((n_vars, n_vars))
    linear = np.zeros(n_vars)
    constant = 0.0
    for v in range(n_nodes):
        constant += penalty
        for c in range(n_colors):
            linear[var(v, c)] -= penalty
            for c2 in range(c + 1, n_colors):
                quadratic[var(v, c), var(v, c2)] += 2.0 * penalty
    for (u, v) in edges:
        if not (0 <= u < n_nodes and 0 <= v < n_nodes) or u == v:
            raise ValueError(f"invalid edge ({u}, {v})")
        for c in range(n_colors):
            quadratic[var(u, c), var(v, c)] += conflict_weight
    return qubo_hamiltonian(quadratic, linear, constant)


def decode_coloring(state: int, n_nodes: int, n_colors: int) -> Optional[list[int]]:
    """Basis state -> color per node, or None when a one-hot constraint
    is violated."""
    bits = decode_qubo_bits(state, n_nodes * n_colors)
    colors = []
    for v in range(n_nodes):
        chosen = [c for c in range(n_colors) if bits[v * n_colors + c]]
        if len(chosen) != 1:
            return None
        colors.append(chosen[0])
    return colors


@dataclass(frozen=True)
class BoundedIntegerVariable:
    """A bounded integer variable in the binary coding qiskit-optimization's
    ``IntegerToBinary`` uses: value = lb + sum_i c_i b_i with c_i = 2^i
    except the last coefficient, which is clipped so the maximum hits
    exactly ``ub`` (reference workflow: model.py:18-23).

    :param name: variable name (for decoding reports)
    :param lowerbound / upperbound: inclusive integer range
    """

    name: str
    lowerbound: int
    upperbound: int

    def __post_init__(self):
        if self.upperbound <= self.lowerbound:
            raise ValueError("upperbound must exceed lowerbound")

    @property
    def n_bits(self) -> int:
        return ceil(log2(self.upperbound - self.lowerbound + 1))

    @property
    def coefficients(self) -> tuple[int, ...]:
        span = self.upperbound - self.lowerbound
        coeffs = [1 << i for i in range(self.n_bits - 1)]
        coeffs.append(span - ((1 << (self.n_bits - 1)) - 1))
        return tuple(coeffs)

    def value_from_bits(self, bits: Sequence[int]) -> int:
        if len(bits) != self.n_bits:
            raise ValueError(f"{self.name} needs exactly {self.n_bits} bits")
        return self.lowerbound + sum(c * b for c, b in zip(self.coefficients, bits))


class IntegerQuadraticProgram:
    """A quadratic objective over bounded integer variables, lowered to a
    QUBO over the variables' binary codings — the native counterpart of
    the reference's docplex -> IntegerToBinary -> to_ising pipeline.

    Usage::

        program = IntegerQuadraticProgram()
        x = program.integer_var(0, 3, "x")
        y = program.integer_var(0, 3, "y")
        program.minimize(quadratic={(x, x): 1.0, (y, y): -1.0})
        hamiltonian, offset = program.to_ising()
        values = program.decode(state)    # {"x": ..., "y": ...}
    """

    def __init__(self) -> None:
        self._variables: list[BoundedIntegerVariable] = []
        self._quadratic: dict[tuple[int, int], float] = {}
        self._linear: dict[int, float] = {}
        self._constant: float = 0.0

    def integer_var(self, lowerbound: int, upperbound: int, name: str) -> int:
        """Register a variable; returns its index."""
        self._variables.append(BoundedIntegerVariable(name, lowerbound, upperbound))
        return len(self._variables) - 1

    def minimize(
        self,
        quadratic: Optional[dict[tuple[int, int], float]] = None,
        linear: Optional[dict[int, float]] = None,
        constant: float = 0.0,
    ) -> None:
        """Set the objective  sum q_ij v_i v_j + sum l_i v_i + c."""
        self._quadratic = dict(quadratic or {})
        self._linear = dict(linear or {})
        self._constant = float(constant)

    @property
    def n_qubits(self) -> int:
        return sum(variable.n_bits for variable in self._variables)

    def _bit_layout(self) -> list[tuple[int, int]]:
        """Per variable: (first qubit index, n_bits), variables packed in
        registration order from qubit 0 upward."""
        layout = []
        cursor = 0
        for variable in self._variables:
            layout.append((cursor, variable.n_bits))
            cursor += variable.n_bits
        return layout

    def to_ising(self) -> tuple[PauliSum, float]:
        """Lower to (diagonal PauliSum, constant offset)."""
        n = self.n_qubits
        layout = self._bit_layout()
        # per-variable affine form over the global bit vector:
        # v_k = lb_k + sum_b w_kb x_b
        weights = np.zeros((len(self._variables), n))
        lbs = np.array([v.lowerbound for v in self._variables], dtype=np.float64)
        for k, (start, bits) in enumerate(layout):
            for b, coeff in enumerate(self._variables[k].coefficients):
                weights[k, start + b] = coeff

        quadratic = np.zeros((n, n))
        linear = np.zeros(n)
        constant = self._constant
        for (i, j), q in self._quadratic.items():
            # v_i v_j = (lb_i + w_i.x)(lb_j + w_j.x)
            quadratic += q * np.outer(weights[i], weights[j])
            linear += q * (lbs[i] * weights[j] + lbs[j] * weights[i])
            constant += q * lbs[i] * lbs[j]
        for i, l in self._linear.items():
            linear += l * weights[i]
            constant += l * lbs[i]
        return qubo_hamiltonian(quadratic, linear, constant)

    def decode(self, state: int) -> dict[str, int]:
        """Basis state -> named integer values."""
        values = {}
        for variable, (start, bits) in zip(self._variables, self._bit_layout()):
            assignment = [(state >> (start + b)) & 1 for b in range(bits)]
            values[variable.name] = variable.value_from_bits(assignment)
        return values

    def objective_value(self, values: dict[str, int]) -> float:
        """Objective at an integer assignment (for validation)."""
        by_index = [values[v.name] for v in self._variables]
        total = self._constant
        for (i, j), q in self._quadratic.items():
            total += q * by_index[i] * by_index[j]
        for i, l in self._linear.items():
            total += l * by_index[i]
        return total
