"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface (the
tensor-core bodies include the shared ``csrc/hopper.cuh``) and is
compiled at first use with ``nvcc`` for Hopper (``sm_90a``) into a shared
library that :mod:`ctypes` loads; no PyTorch headers are involved, so a
build takes seconds. Libraries are keyed by a hash of their source and
land in ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``). Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

# every hand-written kernel of the port, one source each
KERNELS = ("ca_attention", "stage_mlp_block", "flash_attention", "ssd_scan",
           "grouped_moe_ffn")

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# per kernel name: seconds spent in nvcc, and its ptxas report (registers,
# shared memory, spills), for callers that report the build
BUILD_SECONDS: Dict[str, float] = {}
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled at "
                       "first use and need the CUDA toolkit")


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """The library of ``csrc/<name>.cu``, keyed by its source, the shared
    headers ``csrc/*.cuh``, the flags and the ``-D`` defines."""
    text = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    digest = hashlib.blake2b(text + " ".join(flags).encode(),
                             digest_size=8).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``-D`` of each of ``defines``)
    unless a library of the same source exists.

    The library is written to a temporary file and renamed into place, so
    concurrent builders never load a half-written file."""
    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *[f"-D{d}" for d in defines], "-o", tmp,
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOG[name] = proc.stderr
    return out


def build_all() -> List[Path]:
    """Build every kernel of :data:`KERNELS`, one ``nvcc`` process per
    source, all started together."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return list(pool.map(build, KERNELS))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LOADED[name] = lib
        return lib
