"""Build and load the port's CUDA C++ kernels.

Each source under `diffusers_tpu_torch/csrc/` has a plain C interface. `nvcc
-gencode arch=compute_90a,code=sm_90a` compiles it into a shared library under
the repository's `build/` directory on first use, keyed by a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags; `ctypes` loads it
and the kernel's module declares the `argtypes` of every entry point.
`build_all` starts one nvcc per source at once and waits for all of them.
The libraries link only against the CUDA runtime: the driver's
`cuTensorMapEncodeTiled`, which TMA needs, is reached through
`cudaGetDriverEntryPoint` (`csrc/hopper.cuh`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels build from source with the CUDA toolkit")


def library_path(src: Path) -> Path:
    """The library built from `src`, named by a hash of the source, every
    shared header it may include and the flags, so that a change to any of
    them rebuilds."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def _start(src: Path) -> Optional[subprocess.Popen]:
    lib = library_path(src)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(src: Path, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    output, _ = proc.communicate()
    lib = library_path(src)
    lib.with_suffix(".log").write_text(output)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} with exit code {proc.returncode}:\n{output[-8000:]}")
    os.replace(tmp, lib)


def build_all(sources: Iterable[Path]) -> None:
    """Compile every source that is not built yet, all nvcc processes at once."""
    sources = list(sources)
    procs = [_start(src) for src in sources]
    for src, proc in zip(sources, procs):
        _finish(src, proc)


def load(src: Path) -> ctypes.CDLL:
    """Build `src` if needed and load its shared library. A compile error
    raises with nvcc's output."""
    build_all([src])
    return ctypes.CDLL(str(library_path(src)))


def build_log(src: Path) -> str:
    """nvcc's output for the current `src` (with `-Xptxas -v`: registers,
    shared memory, spills), once it has been built in this checkout."""
    log = library_path(src).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def is_hopper(device_index: int) -> bool:
    """Whether the CUDA device is sm_90 (the kernels' only target)."""
    return torch.cuda.get_device_capability(device_index) == (9, 0)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of the CUDA device: the grid of a persistent
    kernel, which the kernel also reads at launch."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def stream_of(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on `device`, for a launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)
