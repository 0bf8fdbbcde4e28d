"""JSON (de)serialization of the full solver result.

Counterpart of ``queasars_tpu/solver/serialization.py`` (results are host
data).  Behavioral port of queasars/minimum_eigensolvers/base/serialization.py:
20-260, with two substitutions: genomes encode via the EVQE genome codec
(as the reference does, :36-39) and the initial state stores complex
amplitudes directly instead of QPY circuit bytes (:57-61) — there are no
circuit objects in this framework.  Includes the decoder fix for the
reference's latent ``result.generation``/``generations`` bug (:256).
"""

from __future__ import annotations

from json import JSONDecoder, JSONEncoder
from typing import Any

import numpy as np

from queasars_tpu_torch.evolve.base import BasePopulationEvaluationResult
from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.population import EVQEPopulation
from queasars_tpu_torch.genome.serialization import (
    EVQECircuitLayerEncoder,
    EVQEPopulationJSONDecoder,
    EVQEPopulationJSONEncoder,
)
from queasars_tpu_torch.solver.result import EvolvingAnsatzMinimumEigensolverResult


class EvolvingAnsatzMinimumEigensolverResultJSONEncoder(JSONEncoder):
    """Serializes results, population evaluations, genomes, complex values
    (reference key scheme: base/serialization.py:20-119)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._genome_encoder = EVQEPopulationJSONEncoder(*args, **kwargs)

    def default(self, o: Any):
        if isinstance(o, (EVQEIndividual, EVQEPopulation)) or any(
            isinstance(o, t) for t in EVQECircuitLayerEncoder.serializable_types()
        ):
            return self._genome_encoder.default(o)

        if isinstance(o, complex):
            return {"complex_re": o.real, "complex_im": o.imag}

        if isinstance(o, np.ndarray):
            if np.iscomplexobj(o):
                return {
                    "ndarray_re": o.real.tolist(),
                    "ndarray_im": o.imag.tolist(),
                }
            return {"ndarray": o.tolist()}

        if isinstance(o, BasePopulationEvaluationResult):
            return {
                "population_evaluation_population": self.default(o.population),
                "population_evaluation_expectation_values": list(o.expectation_values),
                "population_evaluation_best_individual": self.default(o.best_individual),
                "population_evaluation_best_expectation_value": o.best_expectation_value,
            }

        if isinstance(o, EvolvingAnsatzMinimumEigensolverResult):
            return {
                "result_eigenvalue": o.eigenvalue,
                "result_eigenstate": (
                    None
                    if o.eigenstate is None
                    else [[int(state), float(prob)] for state, prob in o.eigenstate.items()]
                ),
                "result_best_individual": (
                    None if o.best_individual is None else self.default(o.best_individual)
                ),
                "result_circuit_evaluations": o.circuit_evaluations,
                "result_generations": o.generations,
                "result_population_evaluation_results": (
                    None
                    if o.population_evaluation_results is None
                    else [self.default(r) for r in o.population_evaluation_results]
                ),
                "result_initial_state": (
                    None if o.initial_state is None else self.default(np.asarray(o.initial_state))
                ),
                "result_aux_operators_evaluated": o.aux_operators_evaluated,
            }

        return super().default(o)


class EvolvingAnsatzMinimumEigensolverResultJSONDecoder(JSONDecoder):
    """Inverse of the result encoder
    (reference: base/serialization.py:122-260)."""

    def __init__(self, *args, **kwargs):
        super().__init__(object_hook=self.object_hook, *args, **kwargs)
        self._genome_hook = EVQEPopulationJSONDecoder().object_hook

    def object_hook(self, object_dict):
        if "complex_re" in object_dict:
            return complex(object_dict["complex_re"], object_dict["complex_im"])
        if "ndarray_re" in object_dict:
            return np.asarray(object_dict["ndarray_re"]) + 1j * np.asarray(object_dict["ndarray_im"])
        if "ndarray" in object_dict and len(object_dict) == 1:
            return np.asarray(object_dict["ndarray"])
        if "population_evaluation_population" in object_dict:
            return BasePopulationEvaluationResult(
                population=object_dict["population_evaluation_population"],
                expectation_values=tuple(object_dict["population_evaluation_expectation_values"]),
                best_individual=object_dict["population_evaluation_best_individual"],
                best_expectation_value=object_dict["population_evaluation_best_expectation_value"],
            )
        if "result_eigenvalue" in object_dict:
            result = EvolvingAnsatzMinimumEigensolverResult()
            result.eigenvalue = object_dict["result_eigenvalue"]
            raw_eigenstate = object_dict["result_eigenstate"]
            result.eigenstate = (
                None
                if raw_eigenstate is None
                else {int(state): float(prob) for state, prob in raw_eigenstate}
            )
            result.best_individual = object_dict["result_best_individual"]
            result.circuit_evaluations = object_dict["result_circuit_evaluations"]
            result.generations = object_dict["result_generations"]
            result.population_evaluation_results = object_dict["result_population_evaluation_results"]
            result.initial_state = object_dict["result_initial_state"]
            result.aux_operators_evaluated = object_dict["result_aux_operators_evaluated"]
            return result
        return self._genome_hook(object_dict)
