"""Build a CUDA source of the package with nvcc and load it with ctypes.

Each kernel source under `rsvldm_tpu_torch/csrc/` exposes a plain C entry
point. It is compiled at first use for Hopper (`sm_90a`) into
`rsvldm_tpu_torch/build/`, one shared library per source, named by the hash
of the source and of the package's headers it includes, so that a stale
library is never loaded. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}  # loaded once per process
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of rsvldm_tpu_torch "
                       "are built with the CUDA toolkit on the machine with "
                       "the card")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(source: str) -> list[Path]:
    """`csrc/<source>` and every file it reaches through `#include "..."`,
    transitively, each resolved beside the file that includes it; includes
    that resolve to nothing there are the toolkit's and are skipped."""
    seen: list[Path] = []
    todo = [(CSRC_DIR / source).resolve()]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / name.decode()).resolve()
            if dep.is_file():
                todo.append(dep)
    return seen


def library_path(source: str) -> Path:
    """The library of `csrc/<source>`, named by the hash of the source and
    of every header of the package it includes."""
    h = hashlib.sha1()
    for path in _sources(source):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build(source: str) -> str:
    """Compile `csrc/<source>` unless its library is already built; returns
    nvcc's output (register and shared-memory use), "" when cached."""
    out = library_path(source)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return res.stdout + res.stderr


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build(source)
            lib = ctypes.CDLL(str(library_path(source)))
            _libs[source] = lib
        return lib
