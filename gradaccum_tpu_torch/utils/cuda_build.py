"""Build a CUDA source of the package into a shared library, at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
by ``nvcc`` for Hopper (``sm_90a``), then loaded with :mod:`ctypes`. The
library is cached under ``build/kernels/`` at the root of the checkout,
keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one loads
at once. The compiler's report (``-Xptxas -v``:
registers, shared memory, spills per kernel) lands beside the library as
``<name>-<hash>.log``.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# seconds spent compiling each library in this process (0.0: loaded from the
# cache); chip_smoke.py reports it
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for path in candidates:
        if os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked under CUDA_HOME and PATH): the CUDA kernels "
        "of gradaccum_tpu_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives once built."""
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(source + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the cached library is current."""
    lib = library_path(name)
    if lib.exists():
        build_seconds.setdefault(name, 0.0)
        return lib
    t0 = time.perf_counter()
    compile_source(CSRC_DIR / f"{name}.cu", lib)
    build_seconds[name] = time.perf_counter() - t0
    return lib


def compile_source(source: Path, lib: Path) -> None:
    """nvcc ``source`` into ``lib`` with the package's flags, the report
    beside it as ``<lib>.log``; raises with the compiler's errors."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    log = lib.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {source} (exit {proc.returncode}); "
            f"log: {log}\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)  # atomic: a reader never sees a half-written file


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        cached: Optional[ctypes.CDLL] = _loaded.get(name)
        if cached is None:
            cached = ctypes.CDLL(str(build(name)))
            _loaded[name] = cached
        return cached
