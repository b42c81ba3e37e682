"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, on first use, into ``build/repro_torch/``
at the root of the checkout, and bound with :mod:`ctypes` (no PyTorch
headers: a build takes seconds, not minutes).  A library's file name carries
a hash of its source, the shared headers and the flags, so an edited source
is rebuilt and a stale one is never loaded.  A failed build raises with the
compiler's output.

Nothing here runs at import time: the CPU tests import every module on a
host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

from .obs import LaunchCounter

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
SOURCES = ("snapshot_patch", "flash_attention", "flash_attention_bwd", "ssd_scan",
           "ssd_scan_bwd", "decode_attention_int8")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per source: compiler output of the last build in this process (ptxas
#: register / shared-memory report), for the chip smoke run to print
build_log: Dict[str, str] = {}
#: libraries loaded (and built where needed) in this process
loads = LaunchCounter("kernels.loads")


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    path, else the toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every header under
    ``csrc/`` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _compile(name: str) -> float:
    """Compile one source unless its hashed library exists; seconds spent."""
    out = library_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {r.returncode}):\n"
            f"{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)
    build_log[name] = (r.stdout + r.stderr).strip()
    return time.perf_counter() - t0


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source, one ``nvcc`` each, all started together.
    Returns the compile seconds per source (0.0 where already built)."""
    names = list(names)
    with _lock, ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        return dict(zip(names, ex.map(_compile, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(library_path(name)))
            loads.add()
        return _libs[name]
