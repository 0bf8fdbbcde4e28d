"""JSON (de)serialization for the JSSP data model.

Counterpart of ``queasars_tpu/problems/jssp/serialization.py``.
Wire-compatible with the reference codec
(queasars/job_shop_scheduling/serialization.py:18-193): the same sentinel
keys ("machine_name", "operation_name", "tuple", "dict", ...) are used so
JSON produced by either implementation round-trips through the other.

Implementation is table-driven: one spec per dataclass maps constructor
fields to their wire keys, and both directions (encode/decode) are
generated from it.
"""

from __future__ import annotations

from json import JSONDecoder, JSONEncoder
from typing import Any

from queasars_tpu_torch.problems.jssp.problem_instances import (
    Job,
    JobShopSchedulingProblemInstance,
    JobShopSchedulingResult,
    Machine,
    Operation,
    ScheduledOperation,
    UnscheduledOperation,
)

#: dataclass -> ordered (constructor_field, wire_key) pairs; the FIRST wire
#: key doubles as the decoder's dispatch sentinel
_WIRE_SPECS: dict[type, tuple[tuple[str, str], ...]] = {
    Machine: (("name", "machine_name"),),
    Operation: (
        ("name", "operation_name"),
        ("job_name", "operation_job_name"),
        ("machine", "operation_machine"),
        ("processing_duration", "operation_processing_duration"),
    ),
    Job: (("name", "job_name"), ("operations", "job_operations")),
    JobShopSchedulingProblemInstance: (
        ("name", "jssp_instance_name"),
        ("machines", "jssp_instance_machines"),
        ("jobs", "jssp_instance_jobs"),
    ),
    UnscheduledOperation: (("operation", "unscheduled_operation"),),
    ScheduledOperation: (
        ("operation", "scheduled_operation"),
        ("start_time", "scheduled_start_time"),
    ),
    JobShopSchedulingResult: (
        ("problem_instance", "jssp_result_problem_instance"),
        ("schedule", "jssp_result_schedule"),
    ),
}

_SENTINEL_TO_TYPE = {spec[0][1]: cls for cls, spec in _WIRE_SPECS.items()}


class JSSPJSONEncoder(JSONEncoder):
    """Serializes the JSSP data model plus tuple/dict containers
    (reference key scheme: serialization.py:31-78)."""

    def default(self, o: Any) -> Any:
        if isinstance(o, tuple):
            return {"tuple": [self.default(entry) for entry in o]}
        if isinstance(o, list):
            return [self.default(entry) for entry in o]
        if isinstance(o, dict):
            return {"dict": self.default(list(o.items()))}
        spec = _WIRE_SPECS.get(type(o))
        if spec is not None:
            payload = {}
            for field, wire_key in spec:
                value = getattr(o, field)
                payload[wire_key] = value if isinstance(value, (str, int, float)) else self.default(value)
            return payload
        return o


class JSSPJSONDecoder(JSONDecoder):
    """Inverse of :class:`JSSPJSONEncoder` via sentinel-key dispatch
    (reference: serialization.py:94-133)."""

    def __init__(self, *args, **kwargs):
        super().__init__(object_hook=self.object_hook, *args, **kwargs)

    @staticmethod
    def object_hook(object_dict):
        if len(object_dict) == 1:
            if "tuple" in object_dict:
                return tuple(object_dict["tuple"])
            if "dict" in object_dict:
                return dict(object_dict["dict"])
        for sentinel, cls in _SENTINEL_TO_TYPE.items():
            if sentinel in object_dict:
                kwargs = {
                    field: object_dict[wire_key] for field, wire_key in _WIRE_SPECS[cls]
                }
                return cls(**kwargs)
        return object_dict
