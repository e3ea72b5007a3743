"""Build the port's native libraries from its sources at first use.

* Each ``csrc/<name>.cu`` (``KERNELS``) has a plain C interface and is
  compiled by ``nvcc`` for Hopper (``sm_90a``); the first load of any of
  them builds every one not built yet, together.
* ``native/solver.cpp`` (the exact endgame solver, host code; it includes
  ``native/rules.h``) is compiled by the host C++ compiler with the flags of
  the JAX package's ``native/Makefile``.

Every library goes to ``_build/lib<name>_<hash>.so``, keyed by a hash of
its sources and flags, and is loaded with ``ctypes``. Nothing includes
PyTorch's headers, so a build takes seconds. The build directory is listed
in ``.gitignore``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
NATIVE = PACKAGE / "native"
BUILD_DIR = PACKAGE / "kernels" / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")
KERNELS = ("backup_link", "bn_act")  # csrc/<name>.cu
SOLVER = "solver"
SOLVER_SOURCES = (NATIVE / "solver.cpp", NATIVE / "rules.h")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: building the port's CUDA kernels "
                       "needs the CUDA toolkit (nvcc on PATH or under "
                       "/usr/local/cuda/bin)")


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++ on PATH): the "
                       "endgame solver library cannot be built")


def _hashed(name: str, sources: Iterable[Path], flags) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for source in sources:
        h.update(source.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    return _hashed(name, [CSRC / f"{name}.cu"], NVCC_FLAGS)


def solver_library_path() -> Path:
    return _hashed(SOLVER, SOLVER_SOURCES, HOST_FLAGS)


def _compile(jobs: Dict[str, Tuple[List[str], Path]]) -> None:
    """Run every ``(command, output)`` job at once; each writes a temporary
    file that replaces ``output`` atomically on success. Raises with the
    compilers' logs if any job fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (cmd, out) in jobs.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (subprocess.Popen([*cmd, "-o", tmp],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            errors.append(f"build of {name} failed "
                          f"(exit {proc.returncode}):\n{log}")
    if errors:
        raise RuntimeError("\n".join(errors))


def build(names: Iterable[str], solver: bool = False) -> Dict[str, Path]:
    """Compile every named CUDA kernel (and with ``solver`` the endgame
    solver library, under the key ``SOLVER``) that is not built yet, one
    compiler per source, all started together. Raises if a compiler is
    missing or any build fails."""
    paths = {name: library_path(name) for name in names}
    if solver:
        paths[SOLVER] = solver_library_path()
    jobs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        if name == SOLVER:
            jobs[name] = ([_cxx(), *HOST_FLAGS, str(SOLVER_SOURCES[0])], out)
        else:
            jobs[name] = ([_nvcc(), *NVCC_FLAGS, str(CSRC / f"{name}.cu")],
                          out)
    if jobs:
        _compile(jobs)
    return paths


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it (and every
    other kernel of ``KERNELS`` not built yet, in parallel) if needed."""
    return ctypes.CDLL(str(build(KERNELS)[name]))


@functools.lru_cache(maxsize=None)
def load_solver() -> ctypes.CDLL:
    """The endgame solver library, building it if needed."""
    return ctypes.CDLL(str(build([], solver=True)[SOLVER]))
