"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``src/repro_torch/csrc/`` is compiled on first use into its
own shared library with a plain C entry point, for ``sm_90a`` (Hopper), into
``build/kernels/`` at the root of the checkout. The file name carries a hash
of the source, of every header under ``csrc/`` and of the flags, so an edited
source or header is rebuilt and a build is never shared between versions.
:func:`build` starts one ``nvcc`` per missing library, all at once, and waits
for them together.

Nothing here runs at import time: machines without ``nvcc`` import the
package and use the plain versions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

SOURCES = {
    "triple_match": "triple_match.cu",
    "merge_probe": "merge_probe.cu",
    "triple_match_words": "triple_match_words.cu",
    "triple_match_lanes": "triple_match_lanes.cu",
    "triple_match_words_segmented": "triple_match_words_segmented.cu",
    "lane_refine": "lane_refine.cu",
}
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # nvcc's -Xptxas -v report per built library
# one build or load at a time; the wrappers' launch counters take
# count_lock, since a mesh's shards launch from several threads
_lock = threading.Lock()
count_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / SOURCES[name]).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named library that is not built yet; return all paths."""
    names = list(names)
    paths = {name: library_path(name) for name in names}
    todo = [name for name in names if not paths[name].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build([name])[name]))
                _loaded[name] = lib
    return lib


def preload() -> None:
    """Build (in parallel) and load every kernel library now: a device
    mesh's shard threads then only look them up."""
    if all(name in _loaded for name in SOURCES):
        return
    with _lock:
        build()
    for name in SOURCES:
        library(name)


def check(status: int, what: str) -> None:
    """Raise on a non-zero CUDA status returned by a C launch function."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
