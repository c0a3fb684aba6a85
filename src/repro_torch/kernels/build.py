"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. Nothing here runs
at import: the first call that needs a kernel builds it. The library name
carries a hash of its source, of the headers beside it (``csrc/*.cuh``,
which the sources share) and of the compiler flags, so a changed source or
header is rebuilt and an unchanged one is loaded from ``build/kernels/``
(listed in ``.gitignore``) at the root of the checkout. ``build_all``
starts one ``nvcc`` per source at once and waits for all of them;
``build_log`` returns what ``ptxas`` reported (registers, shared memory,
spills). ``use_source`` builds one kernel from another directory instead
(another version of its source, for an A/B timing in a process of its
own).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


_SOURCE_DIRS: Dict[str, Path] = {}      # name -> directory, by use_source
_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names: one per ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def source_dir(name: str) -> Path:
    """The directory kernel ``name`` is built from: ``csrc/`` unless
    ``use_source`` named another."""
    return _SOURCE_DIRS.get(name, CSRC)


def use_source(name: str, directory) -> Path:
    """Build kernel ``name`` from ``directory/<name>.cu`` (with the headers
    it includes beside it) and bind every later ``load_function(name,
    ...)`` of this process to that library; every other kernel stays the
    tree's. Must come before the kernel's first load: two libraries with
    the same symbols in one process interfere. Returns the library."""
    if name in _LIBS:
        raise RuntimeError(f"{name} is already loaded from "
                           f"{source_dir(name)}")
    _SOURCE_DIRS[name] = Path(directory).resolve()
    return build_all([name])[name]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def headers(directory: Path = None) -> List[str]:
    """The shared headers: every ``*.cuh`` of ``directory`` (``csrc/``)."""
    return sorted(p.name for p in (directory or CSRC).glob("*.cuh"))


def library_path(name: str) -> Path:
    src = source_dir(name)
    key = hashlib.sha256((src / f"{name}.cu").read_bytes())
    for h in headers(src):
        key.update(h.encode() + (src / h).read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built;
    returns (target, tmp, process) or None."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(source_dir(name) / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, started) -> None:
    target, tmp, proc = started
    log, _ = proc.communicate()
    target.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)              # atomic against a racing build


def build_all(names: Sequence[str] = ()) -> Dict[str, Path]:
    """Build every named kernel (all by default), one nvcc each, all at
    once. Returns name -> library path."""
    names = list(names) or sources()
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """What nvcc/ptxas printed when ``name`` was built ('' if unknown)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _load(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]))
    return _LIBS[name]


def load_function(name: str, symbol: str, argtypes: Sequence,
                  restype=ctypes.c_int):
    """The C entry point ``symbol`` of kernel ``name``, built on first use,
    with its ``argtypes`` set and, by default, an ``int`` (cudaError_t)
    result."""
    fn = getattr(_load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err:
        text = getattr(_load(name), f"{name}_error_string")
        text.argtypes = [ctypes.c_int]
        text.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({text(err).decode()})")

