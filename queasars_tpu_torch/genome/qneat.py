"""QNEAT genome: gene-list circuit encoding with NEAT innovation numbers.

Implements the third algorithm the reference names as future work with no
code (reference README.md:3, docs/source/index.rst:10): QNEAT
(arXiv:2304.06981) adapts NEAT (Stanley & Miikkulainen 2002) to
variational-circuit architecture search.  Where EVQE mutates whole
circuit layers, QNEAT evolves an ordered list of *gate genes*, each
stamped with a global innovation number at the moment of its creation —
the historical markings that let NEAT cross over topologically different
parents gene-by-gene and measure compatibility for speciation.

Counterpart of ``queasars_tpu/genome/qneat.py`` (host code).

Gene alphabet: the same U3 / CU3 gates as the EVQE genome (the engine's
native alphabet; the QNEAT paper uses parameterized rotation + controlled
gates).  Each gene carries 3 angles.

Lowering: a gene list is NOT evaluated gate-by-gate.  ``lower``
ASAP-schedules the genes into disjoint-support layers (genes touching
different qubits commute, so each gene lands in the earliest layer after
its per-qubit predecessors) and emits a regular
:class:`~queasars_tpu_torch.genome.individual.EVQEIndividual` — from there the
whole population reuses the packed-tensor engine, the CUDA
kernels, the batched optimizers and the result/serialization stack
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from random import Random
from typing import Optional, Sequence

from queasars_tpu_torch.genome.circuit_layer import EVQECircuitLayer
from queasars_tpu_torch.genome.gates import (
    ControlGate,
    ControlledRotationGate,
    EVQEGate,
    IdentityGate,
    RotationGate,
)
from queasars_tpu_torch.genome.individual import EVQEIndividual

TWO_PI = 6.283185307179586


@dataclass(frozen=True)
class QNEATGene:
    """One gate gene.

    :param innovation: global historical marking (NEAT's innovation
        number) — two genes with the same innovation number describe the
        same structural addition and are aligned in crossover
    :param target: qubit the rotation acts on
    :param control: control qubit for a CU3 gene, -1 for a plain U3
    """

    innovation: int
    target: int
    control: int = -1

    @property
    def is_controlled(self) -> bool:
        return self.control >= 0

    def structure_key(self) -> tuple[int, int]:
        """Structural identity (used for within-generation innovation
        reuse: identical mutations get identical markings)."""
        return (self.target, self.control)


@dataclass(frozen=True)
class QNEATIndividual:
    """Immutable QNEAT genome: gene list (innovation-ordered) + 3 angles
    per gene."""

    n_qubits: int
    genes: tuple[QNEATGene, ...]
    angles: tuple[float, ...]

    def __post_init__(self):
        if len(self.angles) != 3 * len(self.genes):
            raise ValueError("QNEAT genomes carry exactly 3 angles per gene")
        innovations = [g.innovation for g in self.genes]
        if sorted(innovations) != innovations or len(set(innovations)) != len(innovations):
            raise ValueError("genes must be strictly innovation-ordered")
        for gene in self.genes:
            if not 0 <= gene.target < self.n_qubits:
                raise ValueError("gene target out of range")
            if gene.is_controlled and (
                not 0 <= gene.control < self.n_qubits or gene.control == gene.target
            ):
                raise ValueError("gene control out of range or equal to its target")

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @staticmethod
    def minimal(n_qubits: int, randomize: bool, rng: Random) -> "QNEATIndividual":
        """NEAT starts minimal and uniform: one U3 gene per qubit, with
        innovation q for qubit q, shared by the whole initial population
        (so crossover aligns from generation 0)."""
        genes = tuple(QNEATGene(innovation=q, target=q) for q in range(n_qubits))
        if randomize:
            angles = tuple(rng.uniform(0.0, TWO_PI) for _ in range(3 * n_qubits))
        else:
            angles = (0.0,) * (3 * n_qubits)
        return QNEATIndividual(n_qubits=n_qubits, genes=genes, angles=angles)

    def with_gene(self, gene: QNEATGene, gene_angles: Sequence[float]) -> "QNEATIndividual":
        """Append a structural gene (innovation must exceed all present)."""
        return QNEATIndividual(
            n_qubits=self.n_qubits,
            genes=self.genes + (gene,),
            angles=self.angles + tuple(gene_angles),
        )

    def with_angles(self, angles: Sequence[float]) -> "QNEATIndividual":
        return QNEATIndividual(
            n_qubits=self.n_qubits, genes=self.genes, angles=tuple(angles)
        )

    # ------------------------------------------------------------------
    # NEAT genetics
    # ------------------------------------------------------------------

    def compatibility_distance(
        self, other: "QNEATIndividual", c_excess: float, c_disjoint: float, c_angles: float
    ) -> float:
        """NEAT compatibility: delta = (c1 E + c2 D) / N + c3 * mean
        matching-gene angle distance (NEAT eq. 1; QNEAT uses the same
        form over gate genes)."""
        mine = {g.innovation: i for i, g in enumerate(self.genes)}
        theirs = {g.innovation: i for i, g in enumerate(other.genes)}
        if not mine and not theirs:
            return 0.0
        max_mine = max(mine) if mine else -1
        max_theirs = max(theirs) if theirs else -1
        cutoff = min(max_mine, max_theirs)
        matching = mine.keys() & theirs.keys()
        non_matching = mine.keys() ^ theirs.keys()
        excess = sum(1 for i in non_matching if i > cutoff)
        disjoint = len(non_matching) - excess
        n = max(len(self.genes), len(other.genes), 1)
        angle_diff = 0.0
        if matching:
            total = 0.0
            for innovation in matching:
                a = self.angles[3 * mine[innovation] : 3 * mine[innovation] + 3]
                b = other.angles[3 * theirs[innovation] : 3 * theirs[innovation] + 3]
                total += sum(abs(x - y) for x, y in zip(a, b)) / 3.0
            angle_diff = total / len(matching)
        return (c_excess * excess + c_disjoint * disjoint) / n + c_angles * angle_diff

    @staticmethod
    def crossover(
        fitter: "QNEATIndividual",
        weaker: "QNEATIndividual",
        rng: Random,
        equal_fitness: bool = False,
    ) -> "QNEATIndividual":
        """NEAT crossover: matching genes take their angles from a random
        parent; disjoint/excess genes come from the fitter parent (from
        both when fitness ties)."""
        weaker_by_innovation = {g.innovation: i for i, g in enumerate(weaker.genes)}
        genes: list[QNEATGene] = []
        angles: list[float] = []
        for i, gene in enumerate(fitter.genes):
            j = weaker_by_innovation.get(gene.innovation)
            genes.append(gene)
            if j is not None and rng.random() < 0.5:
                angles.extend(weaker.angles[3 * j : 3 * j + 3])
            else:
                angles.extend(fitter.angles[3 * i : 3 * i + 3])
        if equal_fitness:
            fitter_innovations = {g.innovation for g in fitter.genes}
            for j, gene in enumerate(weaker.genes):
                if gene.innovation not in fitter_innovations and rng.random() < 0.5:
                    genes.append(gene)
                    angles.extend(weaker.angles[3 * j : 3 * j + 3])
            order = sorted(range(len(genes)), key=lambda k: genes[k].innovation)
            genes = [genes[k] for k in order]
            angles = [angles[3 * k + a] for k in order for a in range(3)]
        return QNEATIndividual(
            n_qubits=fitter.n_qubits, genes=tuple(genes), angles=tuple(angles)
        )

    # ------------------------------------------------------------------
    # lowering to layers
    # ------------------------------------------------------------------

    def lower(self) -> EVQEIndividual:
        """ASAP-schedule the gene list into disjoint-support layers and
        emit the packed-tensor-ready :class:`EVQEIndividual`.

        Genes apply in innovation order; a gene lands in the earliest
        layer after every earlier gene sharing one of its qubits, so the
        circuit semantics equal sequential gene application while the
        layer count stays near (genes / qubits)."""
        depth = [0] * self.n_qubits
        placements: list[tuple[int, QNEATGene, tuple[float, ...]]] = []
        n_layers = 0
        for i, gene in enumerate(self.genes):
            qubits = [gene.target] + ([gene.control] if gene.is_controlled else [])
            layer = max(depth[q] for q in qubits)
            for q in qubits:
                depth[q] = layer + 1
            n_layers = max(n_layers, layer + 1)
            placements.append((layer, gene, self.angles[3 * i : 3 * i + 3]))

        slots: list[list[EVQEGate]] = [
            [IdentityGate(qubit_index=q) for q in range(self.n_qubits)]
            for _ in range(max(n_layers, 1))
        ]
        layer_angles: list[dict[int, tuple[float, ...]]] = [{} for _ in range(max(n_layers, 1))]
        for layer, gene, gene_angles in placements:
            if gene.is_controlled:
                slots[layer][gene.target] = ControlledRotationGate(
                    qubit_index=gene.target, control_qubit_index=gene.control
                )
                slots[layer][gene.control] = ControlGate(
                    qubit_index=gene.control, controlled_qubit_index=gene.target
                )
            else:
                slots[layer][gene.target] = RotationGate(qubit_index=gene.target)
            layer_angles[layer][gene.target] = gene_angles

        layers = tuple(
            EVQECircuitLayer(n_qubits=self.n_qubits, gates=tuple(gates)) for gates in slots
        )
        flat: list[float] = []
        for layer_index, layer in enumerate(layers):
            for q in layer.parameterized_qubits():
                flat.extend(layer_angles[layer_index][q])
        return EVQEIndividual(
            n_qubits=self.n_qubits, layers=layers, parameter_values=tuple(flat)
        )

    def pull_angles_from(self, lowered: EVQEIndividual) -> "QNEATIndividual":
        """Inverse of :meth:`lower` for angles: map an optimizer-updated
        lowered individual's flat parameters back onto the gene list
        (structure must be this genome's lowering)."""
        depth = [0] * self.n_qubits
        placement: list[tuple[int, int]] = []  # gene index -> (layer, qubit)
        for gene in self.genes:
            qubits = [gene.target] + ([gene.control] if gene.is_controlled else [])
            layer = max(depth[q] for q in qubits)
            for q in qubits:
                depth[q] = layer + 1
            placement.append((layer, gene.target))
        # flat index of each (layer, qubit) slot in the lowered individual
        slot_offsets: dict[tuple[int, int], int] = {}
        cursor = 0
        for layer_index, layer in enumerate(lowered.layers):
            for q in layer.parameterized_qubits():
                slot_offsets[(layer_index, q)] = cursor
                cursor += 3
        angles: list[float] = []
        for layer_qubit in placement:
            offset = slot_offsets[layer_qubit]
            angles.extend(lowered.parameter_values[offset : offset + 3])
        return self.with_angles(angles)


@dataclass(frozen=True)
class QNEATPopulation:
    """Population of QNEAT genomes plus the NEAT bookkeeping that must
    survive across operators: the global innovation counter and the
    species assignment of the last speciation pass.

    ``elite_flags`` marks species champions copied unchanged into the
    next generation — the mutation operators skip them for one pass
    (NEAT elitism) and clear the flags.
    """

    individuals: tuple[QNEATIndividual, ...]
    next_innovation: int
    species_members: Optional[dict[int, tuple[int, ...]]] = field(default=None)
    species_representatives: Optional[tuple[QNEATIndividual, ...]] = field(default=None)
    elite_flags: Optional[tuple[bool, ...]] = field(default=None)

    @staticmethod
    def initial(
        n_qubits: int, n_individuals: int, randomize: bool, random_seed: Optional[int]
    ) -> "QNEATPopulation":
        rng = Random(random_seed)
        individuals = tuple(
            QNEATIndividual.minimal(n_qubits, randomize, rng) for _ in range(n_individuals)
        )
        return QNEATPopulation(individuals=individuals, next_innovation=n_qubits)
