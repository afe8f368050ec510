"""Build-and-load for the hand-written CUDA kernels.

Each ``<name>.cu`` in this directory has a plain C interface and is compiled
on its own with ``nvcc`` for ``sm_90a`` into a shared library under
``mqslam_tpu_torch/_build/`` (ignored by git), then loaded with ``ctypes``.
Device code that kernels share lives in ``*.cuh`` headers beside them.
The build happens at first use, from the sources here only; ``build_all``
starts one ``nvcc`` per source in parallel so a cold start costs the slowest
single file.  Nothing here is imported at module-import time by the CPU
paths, and nothing falls back when the compiler is missing: ``load`` raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["SRC_DIR", "BUILD_DIR", "sources", "build_all", "load",
           "last_build_seconds"]

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(SRC_DIR), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs = {}
last_build_seconds = 0.0


def sources():
    """Names (without extension) of every kernel source in this directory."""
    return sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith(".cu"))


def _nvcc():
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "mqslam_tpu_torch are compiled at first use and need "
                       "the CUDA toolkit")


def _target(name):
    """(source, library path); the library's name carries a digest of the
    source, every shared header and the compiler flags."""
    src = os.path.join(SRC_DIR, name + ".cu")
    headers = sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                     if f.endswith(".cuh"))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [src] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build_all(names=None):
    """Compile every (or the named) kernel source that has no up-to-date
    library yet, all ``nvcc`` processes started together (and all waited
    for, even when one fails).  Returns {name: compiler output}."""
    global last_build_seconds
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        src, out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():     # every nvcc ends here
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed[0]}.cu:\n"
                           f"{logs[failed[0]]}")
    if procs:
        last_build_seconds = time.perf_counter() - t0
    return logs


def load(name):
    """The ctypes library of kernel source ``name`` (built if needed)."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name] = ctypes.CDLL(_target(name)[1])
    return lib
