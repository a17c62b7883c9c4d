"""ctypes binding for the native NIfTI decode path (runtime/nifti_native.cpp).

Single-pass C++ decode (gzip inflate + header parse + float32 convert +
optional fused CT-window normalization) without holding the GIL — the
loader threads in data/pipeline.py then overlap real decode work.
Falls back silently to the pure-Python reader when the shared library
has not been built (``make -C runtime``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "runtime",
    "libnifti_native.so",
)

NORM_NONE = 0
NORM_CT_WINDOW = 1


class _NiftiMeta(ctypes.Structure):
    _fields_ = [
        ("dim", ctypes.c_int64 * 3),
        ("datatype", ctypes.c_int32),
        ("scl_slope", ctypes.c_float),
        ("scl_inter", ctypes.c_float),
        ("affine", ctypes.c_double * 12),
        ("sform_code", ctypes.c_int32),
        ("qform_code", ctypes.c_int32),
    ]


_lib = None


def available() -> bool:
    global _lib
    if _lib is None and os.path.exists(_LIB_PATH):
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.nifti_load_f32.restype = ctypes.c_int
            lib.nifti_load_f32.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.POINTER(_NiftiMeta),
                ctypes.c_int,
            ]
            _lib = lib
        except OSError:
            _lib = False
    return bool(_lib)


def load_nifti_f32(path: str, norm_mode: int = NORM_NONE):
    """Load a volume as a Fortran-ordered float32 array + (affine, meta).

    Returns None if the native library is unavailable or declines the
    file (e.g. big-endian); callers fall back to the Python reader.
    """
    if not available():
        return None
    meta = _NiftiMeta()
    rc = _lib.nifti_load_f32(path.encode(), None, 0, ctypes.byref(meta), norm_mode)
    if rc != 0:
        return None
    shape = tuple(int(d) for d in meta.dim)
    n = int(np.prod(shape))
    out = np.empty(n, dtype=np.float32)
    rc = _lib.nifti_load_f32(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        ctypes.byref(meta),
        norm_mode,
    )
    if rc != 0:
        return None
    data = out.reshape(shape, order="F")
    affine = np.eye(4)
    if meta.sform_code > 0:
        affine[:3, :4] = np.asarray(meta.affine, dtype=np.float64).reshape(3, 4)
    return data, affine, meta
