"""ctypes binding to the native golden scalar quantizer ``csrc/golden.cpp``
(counterpart of ``quantizations_tpu/utils/golden.py``; the source sits at
the repository root and belongs to neither package).

The golden oracle is host code: scalar, sequential, bit-exact semantics
of bnb's device functions on contiguous numpy buffers, plus the
pair-layout pack. The library is built with ``g++`` at first use into
``quantizations_tpu_torch/build/``, named by the source's hash, so that
an edit rebuilds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "golden.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "build"
_lib: Optional[ctypes.CDLL] = None

_QT = {"fp4": 0, "nf4": 1}


def _build() -> Path:
    """Compile ``csrc/golden.cpp`` unless its library is there: into a
    temporary file first, renamed into place, so that a concurrent build
    never loads a half-written library."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"libgolden_{digest}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp,
                            str(_SRC)], check=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        ll = ctypes.c_longlong
        i = ctypes.c_int
        lib.golden_quantize_4bit.argtypes = [f32p, u8p, f32p, ll, i, i]
        lib.golden_dequantize_4bit.argtypes = [u8p, f32p, f32p, ll, i, i]
        lib.golden_quantize_blockwise_8bit.argtypes = [f32p, f32p, u8p,
                                                       f32p, ll, i]
        lib.golden_dequantize_blockwise_8bit.argtypes = [f32p, u8p, f32p,
                                                         f32p, ll, i]
        lib.golden_gemv_4bit.argtypes = [u8p, f32p, f32p, f32p, ll, ll, i, i]
        lib.golden_repack_bytes_to_i32.argtypes = [u8p, i32p, ll]
        lib.golden_pack_pair.argtypes = [u8p, i32p, ll, ll]
        _lib = lib
    return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def quantize_4bit(
    A: np.ndarray, blocksize: int = 64, quant_type: str = "fp4"
) -> Tuple[np.ndarray, np.ndarray]:
    """Golden scalar 4-bit blockwise quantize -> (packed bytes, absmax)."""
    lib = load()
    A = np.ascontiguousarray(A, dtype=np.float32).reshape(-1)
    n = A.size
    packed = np.zeros((n + 1) // 2, dtype=np.uint8)
    absmax = np.zeros((n + blocksize - 1) // blocksize, dtype=np.float32)
    lib.golden_quantize_4bit(
        _f32(A), _u8(packed), _f32(absmax), n, blocksize, _QT[quant_type]
    )
    return packed, absmax


def dequantize_4bit(
    packed: np.ndarray, absmax: np.ndarray, n: int, blocksize: int = 64,
    quant_type: str = "fp4",
) -> np.ndarray:
    lib = load()
    packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
    absmax = np.ascontiguousarray(absmax, dtype=np.float32)
    out = np.zeros(n, dtype=np.float32)
    lib.golden_dequantize_4bit(
        _u8(packed), _f32(absmax), _f32(out), n, blocksize, _QT[quant_type]
    )
    return out


def quantize_blockwise_8bit(
    code: np.ndarray, A: np.ndarray, blocksize: int = 256
) -> Tuple[np.ndarray, np.ndarray]:
    lib = load()
    code = np.ascontiguousarray(code, dtype=np.float32)
    A = np.ascontiguousarray(A, dtype=np.float32).reshape(-1)
    n = A.size
    q = np.zeros(n, dtype=np.uint8)
    absmax = np.zeros((n + blocksize - 1) // blocksize, dtype=np.float32)
    lib.golden_quantize_blockwise_8bit(
        _f32(code), _f32(A), _u8(q), _f32(absmax), n, blocksize
    )
    return q, absmax


def dequantize_blockwise_8bit(
    code: np.ndarray, q: np.ndarray, absmax: np.ndarray, blocksize: int = 256
) -> np.ndarray:
    lib = load()
    code = np.ascontiguousarray(code, dtype=np.float32)
    q = np.ascontiguousarray(q, dtype=np.uint8).reshape(-1)
    absmax = np.ascontiguousarray(absmax, dtype=np.float32)
    out = np.zeros(q.size, dtype=np.float32)
    lib.golden_dequantize_blockwise_8bit(
        _f32(code), _u8(q), _f32(absmax), _f32(out), q.size, blocksize
    )
    return out


def gemv_4bit(
    packed: np.ndarray, absmax: np.ndarray, x: np.ndarray, M: int, K: int,
    blocksize: int = 64, quant_type: str = "fp4",
) -> np.ndarray:
    lib = load()
    packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
    absmax = np.ascontiguousarray(absmax, dtype=np.float32)
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    out = np.zeros(M, dtype=np.float32)
    lib.golden_gemv_4bit(
        _u8(packed), _f32(absmax), _f32(x), _f32(out), M, K, blocksize,
        _QT[quant_type],
    )
    return out


def repack_bytes_to_i32(packed: np.ndarray) -> np.ndarray:
    """bnb byte layout -> little-endian int32 words (the kernels' planar
    words)."""
    lib = load()
    packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
    assert packed.size % 4 == 0
    out = np.zeros(packed.size // 4, dtype=np.int32)
    lib.golden_repack_bytes_to_i32(
        _u8(packed), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        packed.size,
    )
    return out


def pack_pair(packed: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Golden scalar pair-layout pack (differential reference for
    ``ops/qmatmul.py planar_to_pair``)."""
    lib = load()
    out = np.zeros((rows // 2, cols // 4), np.int32)
    lib.golden_pack_pair(_u8(packed.reshape(-1)),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         rows, cols)
    return out
