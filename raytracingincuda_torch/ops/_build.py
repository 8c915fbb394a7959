"""Build the CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a
plain C interface, named after a hash of the sources and flags, under
``raytracingincuda_torch/_build/``: one ``nvcc -c`` per source, all
started together, then one link. Nothing is built when the package is
imported, so machines without ``nvcc`` import it fine; the first CUDA
launch builds (seconds, since no PyTorch header is included).

``--fmad=false`` keeps every multiply and add separately rounded, as the
eager plain PyTorch version computes them; there is no fast-math flag.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libraytrace_{h.hexdigest()[:16]}.so"


@functools.cache
def load() -> ctypes.CDLL:
    """Build the library if this source hash has none yet, then load it."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        cus = [p for p in sources() if p.suffix == ".cu"]
        objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in cus]
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        jobs = [[nvcc_path(), *compile_flags, "-c", str(p), "-o", str(o)]
                for p, o in zip(cus, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in jobs]
        for cmd, proc in zip(jobs, procs):
            out, _ = proc.communicate()
            _check(cmd, proc.returncode, out)
        tmp = so.with_name(f"{tag}.tmp")
        link = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        _check(link, res.returncode, res.stdout + res.stderr)
        for o in objs:
            o.unlink()
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    return ctypes.CDLL(str(so))


def _check(cmd, returncode: int, output: str) -> None:
    if returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({returncode}): {' '.join(cmd)}\n{output}")


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """A C entry point of the library, with its argument types set and an
    ``int`` (a ``cudaError_t``) result."""
    fn = getattr(load(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
