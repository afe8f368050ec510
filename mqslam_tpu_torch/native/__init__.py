"""Native (C++) host image decoding, built on demand and bound via ctypes.

Mirrors the reference's compile-on-import convention for its native code
(reference: Work/python_libs/triangulation_c/__init__.py:3-11 scipy.weave
build): ``imageio.cpp`` beside this file is compiled with g++ (libpng,
libjpeg) at first use into ``mqslam_tpu_torch/_build/``, under a name that
carries a digest of the source and flags, and loaded with ctypes.  Host code,
not a device kernel; nothing in the package calls it (``io.images`` decodes
with PIL).  Callers ask ``available()``; without the toolchain or the
libraries ``decode_gray`` / ``ImageSequence`` raise with the build error.
"""

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

from mqslam_tpu_torch.csrc import BUILD_DIR

__all__ = ["available", "decode_gray", "ImageSequence", "build"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "imageio.cpp")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LIBS = ["-lpng", "-ljpeg", "-lpthread"]
_lib = None
_load_error = None


def _target():
    """The library's path: its name carries a digest of source and flags."""
    h = hashlib.sha1(" ".join(_FLAGS + _LIBS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmqslam_io_{h.hexdigest()[:12]}.so")


def build(verbose=False):
    """Compile the shared library (g++ -O3, links libpng/libjpeg) unless an
    up-to-date one exists.  Compiles to a temporary name and renames it into
    place, so concurrent processes never load a half-written file."""
    out = _target()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp, *_LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:                      # no g++ at all
        raise RuntimeError(f"native build failed: {e}") from e
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native build failed:\n{res.stderr}")
    os.replace(tmp, out)
    if verbose:
        print(f"built {out}", file=sys.stderr)
    return out


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError) as e:    # toolchain or libraries missing
        _load_error = e
        return None
    lib.mq_decode_gray.restype = ctypes.c_int
    lib.mq_decode_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mq_seq_open.restype = ctypes.c_void_p
    lib.mq_seq_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.mq_seq_next.restype = ctypes.c_int
    lib.mq_seq_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mq_seq_close.restype = None
    lib.mq_seq_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available():
    """True when the library built and loaded (``decode_gray`` raises with
    the build error otherwise)."""
    return _load() is not None


def _need():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native imageio unavailable: {_load_error}")
    return lib


def decode_gray(path, max_h=4096, max_w=4096):
    """Decode one PNG/JPEG to [H, W] float32 grayscale (0..255)."""
    lib = _need()
    buf = np.empty(max_h * max_w, dtype=np.float32)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.mq_decode_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_h * max_w, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"decode failed ({rc}) for {path}")
    return buf[:h.value * w.value].reshape(h.value, w.value).copy()


class ImageSequence:
    """Prefetching iterator over an image sequence (decode off-thread)."""

    def __init__(self, paths, queue_depth=4, max_h=2160, max_w=4096):
        lib = _need()
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.mq_seq_open(arr, len(self._paths), queue_depth,
                                       max_h, max_w)
        self._buf = np.empty(max_h * max_w, dtype=np.float32)

    def __iter__(self):
        return self

    def __next__(self):
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = self._lib.mq_seq_next(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(h), ctypes.byref(w))
        if rc == 1:
            raise StopIteration
        if rc != 0:
            raise IOError(f"sequence decode failed ({rc})")
        return self._buf[:h.value * w.value].reshape(
            h.value, w.value).copy()

    def close(self):
        if self._handle:
            self._lib.mq_seq_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
