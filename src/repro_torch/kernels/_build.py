"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``repro_torch/csrc/*.cu`` file is one kernel library with a plain C
interface (no PyTorch headers, so each compiles in seconds); shared device
code lives in ``csrc/*.cuh`` headers.  The first kernel call builds all of
them at once — one ``nvcc`` process per source, started together — into
``<repo>/build/kernels/`` (listed in ``.gitignore``), named by a hash of
source, headers and flags so an edited source or header is rebuilt.  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# filled by build_all(): wall seconds of the build and nvcc's -Xptxas -v
# report (registers / shared memory / spills per kernel) for each source
build_seconds = None
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels are built on first use")


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every source not yet built, all nvcc processes in parallel.
    Returns {kernel name: library path}."""
    global build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    targets = {s.stem: _target(s) for s in sources}
    todo = [s for s in sources if not targets[s.stem].exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in todo:
            tmp = targets[src.stem].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, tmp, proc in procs:
            out, _ = proc.communicate()
            build_log[src.stem] = out
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, targets[src.stem])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return targets


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of kernel ``name`` (builds everything on the
    first call)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            targets = build_all()
            if name not in targets:
                raise KeyError(f"no CUDA source {name}.cu in {CSRC}")
            for n, path in targets.items():
                _libs[n] = ctypes.CDLL(str(path))
            lib = _libs[name]
        return lib
