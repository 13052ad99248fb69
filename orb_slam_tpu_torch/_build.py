"""Build and load the port's CUDA kernels (``csrc/*.cu``) and its host
extensions (``csrc/graphops.cpp`` and ``csrc/png_unfilter.cpp``, built by
``g++``; see ``load_host_extension``).

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
import importlib.util
import os
import re
import shutil
import subprocess
import sysconfig
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


HOST_SOURCES = ("graphops", "png_unfilter")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def host_extension_path(name: str) -> str:
    """Where csrc/<name>.cpp's Python extension module is built: a
    directory of _build/ named by a hash of the source, the flags and the
    interpreter's ABI, holding _<name><EXT_SUFFIX> (the module's init
    function is PyInit__<name>)."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    with open(os.path.join(CSRC, name + ".cpp"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()
                                + suffix.encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}",
                        f"_{name}{suffix}")


def build_host_extension(name: str) -> str:
    """Compile csrc/<name>.cpp (a plain CPython C extension, no device
    code) with g++ unless an up-to-date build exists.  Returns the module
    path; raises with the compiler's output if the build fails."""
    out = host_extension_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, f"-I{sysconfig.get_paths()['include']}",
           os.path.join(CSRC, name + ".cpp"), "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"g++ {name}.cpp could not run: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"g++ {name}.cpp failed ({r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def load_host_extension(name: str):
    """The Python module of csrc/<name>.cpp, built first if needed (its
    init function is PyInit__<name>).  Raises if the build fails."""
    path = build_host_extension(name)
    spec = importlib.util.spec_from_file_location(
        f"orb_slam_tpu_torch._{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
