"""Build and binding of the port's CUDA kernels.

`nvcc` compiles `csrc/*.cu` for sm_90a into one shared library with a plain
C interface, `_build/libkarttorch.so`, at first use (and again whenever a
source is newer than the library).  The library is loaded with ctypes.
Each wrapper checks its tensors, allocates its outputs with `torch.empty`,
launches on the current CUDA stream, raises if the launch reports an error,
and counts its launches in a plain integer attribute (`.launches`).

Nothing here falls back: a failed build raises with nvcc's output, and a
wrapper given a tensor that is not on a CUDA device raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_PKG, "csrc", f) for f in ("fm_seed_scan.cu", "nw.cu"))
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libkarttorch.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> str:
    """Compile the library if it is missing or older than a source.
    Returns nvcc's output (ptxas register and spill report), empty when
    the library was already up to date."""
    newest = max(os.path.getmtime(s) for s in SOURCES)
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= newest:
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    return proc.stdout + proc.stderr


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB_PATH)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kart_fm_seed_scan.argtypes = [p, p, p, i, p, p, i, i, i, i, p, p]
        lib.kart_fm_seed_scan.restype = i
        lib.kart_nw_planes.argtypes = [p, p, i, i, p, p]
        lib.kart_nw_planes.restype = i
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype, shape, device, align: int = 4) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a cuda tensor, got one on {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: must be contiguous and {align}-byte aligned")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def fm_seed_scan(fm, reads, rlens, min_seed_len: int, *, max_seeds: int, l_max: int):
    """csrc/fm_seed_scan.cu: packed FastMode seeds (B, 1 + 4*max_seeds)
    int32 for reads (B, l_max) int32 and rlens (B,) int32 on the card."""
    dev = reads.device
    B = reads.shape[0]
    _check("reads", reads, torch.int32, (B, l_max), dev)
    _check("rlens", rlens, torch.int32, (B,), dev)
    n_blocks = fm.occ_cp.numel() // 4
    _check("occ_cp", fm.occ_cp, torch.int32, (4 * n_blocks,), dev, align=16)
    _check("bwt_words", fm.bwt_words, torch.int32, (8 * n_blocks,), dev, align=16)
    _check("L2", fm.L2, torch.int32, (5,), dev)
    out = torch.empty((B, 1 + 4 * max_seeds), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.kart_fm_seed_scan(
            fm.occ_cp.data_ptr(), fm.bwt_words.data_ptr(), fm.L2.data_ptr(),
            int(fm.primary), reads.data_ptr(), rlens.data_ptr(), B, l_max,
            int(min_seed_len), int(max_seeds), out.data_ptr(), stream,
        )
    _raise_on(rc, "fm_seed_scan")
    fm_seed_scan.launches += 1
    return out


fm_seed_scan.launches = 0


def nw_planes(c1, c2, *, lm: int):
    """csrc/nw.cu: (N, lm+1, lm+1) uint8 NW decision planes for (N, lm)
    int8 code pairs on the card, lm in (16, 32, 64, 128)."""
    if lm not in (16, 32, 64, 128):
        raise ValueError(f"nw_planes: unsupported tile {lm}")
    dev = c1.device
    n = c1.shape[0]
    _check("c1", c1, torch.int8, (n, lm), dev, align=16)
    _check("c2", c2, torch.int8, (n, lm), dev, align=16)
    out = torch.empty((n, lm + 1, lm + 1), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.kart_nw_planes(c1.data_ptr(), c2.data_ptr(), n, lm, out.data_ptr(), stream)
    _raise_on(rc, "nw_planes")
    nw_planes.launches += 1
    return out


nw_planes.launches = 0
