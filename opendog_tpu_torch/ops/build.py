"""Builds the shared libraries of ``csrc/`` at first use.

A library is keyed by a hash of its compiler command and of every source
under ``csrc/``; it is built once into ``opendog_tpu_torch/_build/`` (listed
in ``.gitignore``) under a file lock, so concurrent processes share one
build.  The compiler's messages are kept beside the library (``.log``), so
that a later process can show them, e.g. the register and spill report of
``nvcc -Xptxas -v``.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from typing import List, Sequence

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")

# -fmad=false: no contraction of a*b+c into one FMA, so the kernel rounds
# operation by operation as its plain PyTorch version (and the JAX package)
# do.  The substep is ill-conditioned on stiff contact states: on random Go1
# states at dt = 0.01 a change of a few ulps in qvel moves the result's qvel
# by up to ~1e-3 after two substeps (chip_smoke.py prints this spread), and
# with contraction the kernel read 3.8e-3 away from its plain version there
# (on an H100).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]


@dataclass
class BuiltLibrary:
    path: str
    log: str  # the compiler's messages
    seconds: float  # build time; 0.0 when an earlier build was reused


def find_nvcc() -> str:
    """Path of ``nvcc``; raises if the CUDA toolkit is missing."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc was not found: the CUDA substep kernel "
                           "cannot be built on this machine")
    return path


def _source_hash(cmd: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(cmd).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_library(name: str, source: str, compiler: str,
                  flags: List[str]) -> BuiltLibrary:
    """Compile ``csrc/<source>`` with ``compiler`` into a shared library
    named after ``name`` and the source hash, unless it exists already."""
    cmd = [compiler, *flags]
    key = _source_hash(cmd + [source])
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"lib{name}-{key}.so")
    log = lib[:-3] + ".log"
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib):
            with open(log) as f:
                return BuiltLibrary(lib, f.read(), 0.0)
        tmp = f"{lib}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            cmd + ["-o", tmp, os.path.join(CSRC, source)],
            capture_output=True, text=True, cwd=CSRC)
        seconds = time.perf_counter() - t0
        out = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"building {source} failed "
                               f"({' '.join(cmd)}):\n{out}")
        with open(log, "w") as f:
            f.write(out)
        os.replace(tmp, lib)
    return BuiltLibrary(lib, out, seconds)
