"""Build and load the hand-written CUDA kernels (``csrc/*.cu``: the slot, the
fold and the compacted-gate kernels, with the shared headers ``csrc/*.cuh``).

All sources are compiled by ONE ``nvcc`` call into a shared library with a
plain C interface, loaded with ``ctypes``.  No PyTorch header is included,
so the build takes seconds; nothing is built when this module is imported,
only at the first launch (or an explicit :func:`build`).

The library lands in ``build/queasars_tpu_torch/`` at the repository root,
under a name that carries a hash of the sources and flags, so an edited
source never loads a stale library.  It is written to a temporary name and
renamed into place: no lock file is involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "queasars_tpu_torch"

#: sm_90a (not sm_90) keeps Hopper-only instructions available.  No
#: --use_fast_math: __sinf/__cosf would cost the 1e-5 gate on U3 entries.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

#: C entry points and their argument types (pointers and the stream are
#: c_void_p; a bare Python int would be passed as a 32-bit int)
SIGNATURES = {
    "qt_energy_partials": [_I],
    "qt_population_states": [_P] * 6 + [_I, _I, _I, _P],
    "qt_energies_exact": [_P] * 9 + [_I, _I, _I, _P],
    "qt_population_probs": [_P] * 7 + [_I, _I, _I, _P],
    "qt_nft_layer_sweep": [_P] * 14 + [_I] * 5 + [_P],
    "qt_fold_states": [_P] * 12 + [_I] * 4 + [_P],
    "qt_fold_probs": [_P] * 13 + [_I] * 4 + [_P],
    "qt_fold_energies": [_P] * 15 + [_I] * 4 + [_P],
    "qt_fold_pair_partials": [_I],
    "qt_fold_nft_sweep": [_P] * 21 + [_I] * 6 + [_P],
    "qt_sampler_scratch": [_I],
    "qt_sampled_shot_indices": [_P] * 9 + [_I] * 4 + [_P],
    "qt_sample_planes": [_P] * 4 + [_I] * 3 + [_P],
    "qt_sampled_shot_indices_folded": [_P] * 15 + [_I] * 5 + [_P],
    "qt_grouped_shot_indices_folded": [_P] * 20 + [_I] * 5 + [_P],
    "qt_compact_energies_exact": [_P] * 9 + [_I] * 5 + [_P],
    "qt_compact_probs": [_P] * 7 + [_I] * 5 + [_P],
}


@dataclass
class BuildInfo:
    """What one build did: the command, its wall seconds, and the
    per-kernel register/spill lines ``-Xptxas -v`` printed."""

    command: list[str]
    seconds: float
    ptxas: list[str]


_library: ctypes.CDLL | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found is not None:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library of the current sources (``*.cu`` and the headers
    they include) and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SOURCE_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libqueasars_kernels_{digest.hexdigest()[:16]}.so"


def build() -> BuildInfo:
    """Compile every ``csrc/*.cu`` with one nvcc call (always rebuilds)."""
    target = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    command = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    start = time.perf_counter()
    proc = subprocess.run(command, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, target)
    output = proc.stdout + proc.stderr
    ptxas = [
        line.strip()
        for line in output.splitlines()
        if re.search(r"Compiling entry|Used \d+ registers|spill", line)
    ]
    return BuildInfo(command=command, seconds=seconds, ptxas=ptxas)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _library
    if _library is None:
        path = library_path()
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library


def check(status: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name} failed with CUDA error {status}")
