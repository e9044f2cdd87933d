"""ctypes binding for the native detection kernels (native/sep_native.cpp;
the port's copy of celeste_jl_tpu/detection/_native.py). Only the
labeling is bound: nothing calls the source's background_cells.

The shared library is compiled with g++ at first use into build/native/ at
the repository root, keyed by a hash of the source, and never into the
package. Without a toolchain `available()` is False and `extract` labels
with scipy.
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "sep_native.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "native")
_lib = None
_tried = False


def _build():
    """Compile the library (unless this source's build exists) and return
    its path. Concurrent processes each compile to a private file and
    rename it."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"libsepnative-{tag}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.cc_label_8.restype = ctypes.c_int32
    lib.cc_label_8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return _lib


def available():
    return _load() is not None


def label(mask):
    """8-connected labeling via the C++ core. mask: (H, W) bool.
    Returns (labels int32 (H, W), n)."""
    lib = _load()
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    H, W = m.shape
    labels = np.zeros((H, W), dtype=np.int32)
    n = lib.cc_label_8(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       H, W,
                       labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels, int(n)

