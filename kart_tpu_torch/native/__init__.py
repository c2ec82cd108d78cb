"""Native (C++) helpers of the port (its own copy of kart_tpu/native).

Offline index construction uses a C++ SA-IS suffix-array routine (sais.cpp),
compiled on demand with g++ into a shared object and loaded via ctypes.
A pure-NumPy prefix-doubling fallback keeps everything functional when no
C++ toolchain is available (slower, same results).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_NATIVE_DIR), "_build")
_LIB = None
_LIB_TRIED = False


def _compile_lib() -> str | None:
    src = os.path.join(_NATIVE_DIR, "sais.cpp")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.join(_BUILD_DIR, "libkartsais.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    tmp = tempfile.mktemp(suffix=".so", dir=_BUILD_DIR)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
        return out
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None


def _load_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = _compile_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.kart_sais_u8.restype = ctypes.c_int
    lib.kart_sais_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _LIB = lib
    return _LIB


def _suffix_array_numpy(text: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array, O(n log^2 n). Fallback path."""
    n = len(text)
    rank = text.astype(np.int64)
    sa = np.argsort(rank, kind="stable").astype(np.int64)
    tmp = np.empty(n, dtype=np.int64)
    k = 1
    while k < n:
        # rank2[i] = rank[i+k] or -1
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[: n - k] = rank[k:]
        key = rank * (n + 1) + (rank2 + 1)
        sa = np.argsort(key, kind="stable").astype(np.int64)
        sorted_key = key[sa]
        tmp[0] = 0
        np.cumsum(sorted_key[1:] != sorted_key[:-1], out=tmp[1:])
        rank = np.empty(n, dtype=np.int64)
        rank[sa] = tmp
        if rank[sa[-1]] == n - 1:
            break
        k <<= 1
    return sa


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of `text` (uint8, values in [1, 255], caller has NOT
    appended a sentinel).  A unique smallest sentinel 0 is appended
    internally; the returned array has length len(text)+1 with sa[0] ==
    len(text) (the sentinel suffix)."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    if text.size and text.min() < 1:
        raise ValueError("text values must be >= 1 (0 is the sentinel)")
    n = text.size + 1
    s = np.empty(n, dtype=np.uint8)
    s[:-1] = text
    s[-1] = 0
    lib = _load_lib()
    if lib is not None:
        sa = np.empty(n, dtype=np.int64)
        k = int(s.max()) + 1
        rc = lib.kart_sais_u8(
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(n),
            ctypes.c_int64(k),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc == 0:
            return sa
    return _suffix_array_numpy(s)
