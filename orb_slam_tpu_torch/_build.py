"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (sm_90a) into its own shared
library with a plain C interface, and loaded with ``ctypes``.  Libraries go
to ``_build/`` beside this file (ignored by git), named by a hash of the
source and the flags, so a changed source is rebuilt and an unchanged one
is reused.  All sources are compiled at once, one ``nvcc`` each, in
parallel.  Nothing is built at import time: the first kernel launch builds.

Every kernel file is built with ``--fmad=false``: without it nvcc contracts
``a*b + c`` into FMAs, which moves .5 rounding cases of the BRIEF sample
coordinates and the last bit of the blur against the plain PyTorch
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("fast_nms_blur", "orient_describe")
# -Xptxas=-v prints each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ by nvcc on the machine with the card")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=SOURCES) -> dict:
    """Compile every named source that has no up-to-date library, one nvcc
    per source, all started together.  Returns {name: library path}; the
    compiler's output is kept beside each library as <path>.log.  Raises
    with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, n + ".cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    errors = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({p.returncode}):\n{log}")
        else:
            if log.strip():
                print(f"# nvcc {n}.cu:\n{log}", flush=True)
            with open(out + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build((name,))[name])
            _libs[name] = lib
        return lib


def parse_ptxas(log: str) -> dict:
    """The most registers any kernel uses and the spill bytes (stores plus
    loads) summed over the kernels, from nvcc's -Xptxas=-v lines."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        log)
    return {"registers": max(regs, default=None),
            "spill_bytes": sum(int(a) + int(b) for a, b in spills)}


def ptxas_info(name: str) -> dict:
    """parse_ptxas of csrc/<name>.cu's build log (built first if needed)."""
    with open(build((name,))[name] + ".log") as f:
        return parse_ptxas(f.read())


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
