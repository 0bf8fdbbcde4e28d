"""Build and load the hand-written CUDA kernels (``csrc/*.cu``: the slot, the
fold, the compacted-gate and the amplitude-shard kernels, the NFT step and
the fold pipeline's build, with the shared headers ``csrc/*.cuh``).

Each source is compiled by its own ``nvcc`` process, all started together,
and one more ``nvcc`` call links the objects into a shared library with a
plain C interface, loaded with ``ctypes``.  No PyTorch header is included,
so the build takes seconds; nothing is built when this module is imported,
only at the first launch (or an explicit :func:`build`).  The wrappers' call
plumbing lives here too: :func:`on_cuda`, :func:`expect`, :func:`ptr`, :func:`stream`.

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

import torch

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
_L = ctypes.c_longlong

#: C entry points and their argument types (pointers and the stream are
#: c_void_p; a bare Python int would be passed as a 32-bit int)
SIGNATURES = {
    "qt_energy_partials": [_I],
    "qt_population_states": [_P] * 6 + [_I, _I, _I, _P],
    "qt_energies_exact": [_P] * 9 + [_I, _I, _I, _P],
    "qt_population_probs": [_P] * 7 + [_I, _I, _I, _P],
    "qt_sweep_partials": [_I],
    "qt_nft_layer_sweep": [_P] * 16 + [_I] * 5 + [_P],
    "qt_fold_states": [_P] * 12 + [_I] * 4 + [_P],
    "qt_fold_probs": [_P] * 13 + [_I] * 4 + [_P],
    "qt_fold_energies": [_P] * 15 + [_I] * 4 + [_P],
    "qt_fold_nft_sweep": [_P] * 22 + [_I] * 6 + [_P],
    "qt_sampler_scratch": [_I],
    "qt_sampled_shot_indices": [_P] * 9 + [_I] * 4 + [_P],
    "qt_sample_planes": [_P] * 4 + [_I] * 3 + [_P],
    "qt_sampled_shot_indices_folded": [_P] * 15 + [_I] * 5 + [_P],
    "qt_grouped_shot_indices_folded": [_P] * 20 + [_I] * 5 + [_P],
    "qt_compact_energies_exact": [_P] * 9 + [_I] * 5 + [_P],
    "qt_compact_probs": [_P] * 7 + [_I] * 5 + [_P],
    "qt_shard_pair_combine": [_P] * 6 + [_I] * 4 + [_P],
    "qt_shard_group_product": [_P] * 3 + [_I] * 4 + [_P],
    "qt_shard_diag_phase": [_P] * 4 + [_I] * 4 + [_P],
    "qt_shard_running_sum": [_P] * 2 + [_L, _I, _P],
    "qt_nft_step": [_P] * 11 + [_I] * 6 + [_P],
    "qt_fold_build": [_P] * 14 + [_I] * 4 + [_P],
}


@dataclass
class BuildInfo:
    """What one build did: the commands (one compile per source, then the
    link), its wall seconds, and the per-kernel register/spill lines
    ``-Xptxas -v`` printed."""

    commands: list[list[str]]
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
    """Compile every ``csrc/*.cu`` in parallel, one nvcc process per source,
    and link them (always rebuilds)."""
    target = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.name}.{os.getpid()}"
    tmp = target.with_name(f"{tag}.tmp")
    compile_flags = [flag for flag in NVCC_FLAGS if flag != "-shared"]
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    commands = [[nvcc_path(), *compile_flags, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources(), objects)]
    link = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objects)]
    start = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in commands]
    outputs = [proc.communicate() for proc in procs]
    failed = [(proc.returncode, err) for proc, (_, err) in zip(procs, outputs) if proc.returncode]
    if not failed:
        linked = subprocess.run(link, capture_output=True, text=True)
        if linked.returncode:
            failed.append((linked.returncode, linked.stderr))
    seconds = time.perf_counter() - start
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        code, err = failed[0]
        raise RuntimeError(f"nvcc failed ({code}):\n{err[-4000:]}")
    os.replace(tmp, target)
    output = "".join(out + err for out, err in outputs)
    ptxas = [
        line.strip()
        for line in output.splitlines()
        if re.search(r"Compiling entry|Used \d+ registers|spill", line)
    ]
    return BuildInfo(commands=[*commands, link], seconds=seconds, ptxas=ptxas)


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


def on_cuda(*tensors: torch.Tensor | None) -> bool:
    """True when every tensor lies on the card, False when every one lies on
    the CPU; anything else (mixed or another device) is refused.  None
    entries (absent optional arguments) are skipped."""
    devices = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"tensors must all lie on one CUDA device or all on the CPU: {devices}")
    return True


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Refuse a kernel argument of another dtype or shape, or not contiguous."""
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor | None):
    """A tensor's device pointer, None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def stream():
    """The current CUDA stream's handle."""
    return torch.cuda.current_stream().cuda_stream
