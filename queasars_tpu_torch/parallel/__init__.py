"""Device-mesh distribution (replaces the reference's dask layer).

Counterpart of ``queasars_tpu/parallel``.  The reference scales by farming
per-individual futures over a dask cluster (SURVEY.md §2.3); here the
population axis is split over a list of devices (``mesh.py``), across
processes joined by ``torch.distributed`` on gloo (``multihost.py``).
"""

from queasars_tpu_torch.parallel.multihost import (
    initialize_multihost,
    is_multihost,
    process_info,
)
from queasars_tpu_torch.parallel.mesh import (
    pad_population_axis,
    population_mesh,
    population_pad_multiple,
    run_population_sharded,
    shard_packed,
    sharded_population_energies,
    sharded_training_step,
)

__all__ = [
    "initialize_multihost",
    "is_multihost",
    "process_info",
    "pad_population_axis",
    "population_mesh",
    "population_pad_multiple",
    "run_population_sharded",
    "shard_packed",
    "sharded_population_energies",
    "sharded_training_step",
]
