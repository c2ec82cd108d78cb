"""Build and binding of the port's CUDA kernels.

`nvcc` compiles each `csrc/*.cu` for sm_90a (all sources at once, one
process each) and links them into one shared library with a plain C
interface, `_build/libkarttorch.so`, at first use (and again whenever a
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
SOURCES = tuple(
    os.path.join(_PKG, "csrc", f)
    for f in ("fm_seed_scan.cu", "nw.cu", "kmer_funnel.cu", "resolve_pack.cu", "row_gather.cu")
)
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libkarttorch.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def build(lib_path: str = LIB_PATH, sources=SOURCES) -> str:
    """Compile the library if it is missing or older than a source.
    Returns nvcc's output (ptxas register and spill report), empty when
    the library was already up to date.  Another `lib_path` and `sources`
    build a library beside it (the kernel benchmark's latency probe)."""
    newest = max(os.path.getmtime(s) for s in sources)
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= newest:
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [os.path.join(tmpdir, os.path.basename(s)[:-3] + ".o") for s in sources]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", src, "-o", obj] for src, obj in zip(sources, objs)]
        procs = [
            subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for c in cmds
        ]
        logs = [p.communicate()[0] for p in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        tmp = os.path.join(tmpdir, "lib.so")
        link = [_nvcc(), "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return "".join(logs)


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
        lib.kart_kmer_funnel.argtypes = [p, p, p, p, i, p, p, p, i, p, i, i, i, i, i, i, i, i,
                                         p, p, p]
        lib.kart_kmer_funnel.restype = i
        lib.kart_kmer_funnel_cluster.argtypes = []
        lib.kart_kmer_funnel_cluster.restype = i
        lib.kart_unpack_reads.argtypes = [p, p, p, i, i, i, p, p]
        lib.kart_unpack_reads.restype = i
        lib.kart_resolve_pack.argtypes = [p, i, i, i, p, i, i, p, p, p, p, p]
        lib.kart_resolve_pack.restype = i
        lib.kart_resolve_scan_words.argtypes = [i]
        lib.kart_resolve_scan_words.restype = i
        lib.kart_row_gather.argtypes = [p, p, i, p, p]
        lib.kart_row_gather.restype = i
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


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def funnel_cluster() -> int:
    """Blocks per slab of the funnel kernel's clusters (a constant of
    csrc/kmer_funnel.cu)."""
    return int(_load().kart_kmer_funnel_cluster())


def kmer_funnel(tt, words, amb_r, amb_p, rlens, min_seed_len: int, *, max_seeds: int,
                l_max: int, hit_cap: int, rounds: int, slab_rows: int, hit_budget: int):
    """csrc/kmer_funnel.cu: packed FastMode funnel seeds (B, 2 +
    4*max_seeds) int32 for 2-bit reads on the card (words (B, ceil(l_max/16))
    int32 bits, amb_r/amb_p (n_amb,) int32, rlens (B,) int32), l_max <= 512,
    against the tables of a KmerTablesTensors.  One thread-block cluster per
    slab of min(B, slab_rows) rows."""
    if l_max > 512:
        raise ValueError(f"kmer_funnel: FastMode takes l_max <= 512, got {l_max}")
    dev = words.device
    B = words.shape[0]
    nwl, nab = -(-l_max // 16), -(-l_max // 32)
    _check("words", words, torch.int32, (B, nwl), dev)
    n_amb = amb_r.shape[0]
    _check("amb_r", amb_r, torch.int32, (n_amb,), dev)
    _check("amb_p", amb_p, torch.int32, (n_amb,), dev)
    _check("rlens", rlens, torch.int32, (B,), dev)
    _check("table_lo", tt.table_lo, torch.int32, (4**13 + 1,), dev)
    _check("sub_tbl", tt.sub_tbl, torch.int16, (4**13,), dev)
    _check("sa_full", tt.sa_full, torch.int32, (tt.seq_len + 1,), dev)
    _check("text_words", tt.text_words, torch.int32, tuple(tt.text_words.shape), dev)
    out = torch.empty((B, 2 + 4 * max_seeds), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    ambm = torch.empty((B, nab), dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.kart_kmer_funnel(
            tt.table_lo.data_ptr(), tt.sub_tbl.data_ptr(), tt.sa_full.data_ptr(),
            tt.text_words.data_ptr(), tt.seq_len,
            words.data_ptr(), amb_r.data_ptr(), amb_p.data_ptr(), n_amb, rlens.data_ptr(),
            B, l_max, int(min_seed_len), max_seeds, hit_cap, rounds, slab_rows, hit_budget,
            ambm.data_ptr(), out.data_ptr(), _stream(dev),
        )
    _raise_on(rc, "kmer_funnel")
    kmer_funnel.launches += 1
    return out


kmer_funnel.launches = 0


def unpack_reads(words, amb_r, amb_p, *, l_max: int):
    """csrc/kmer_funnel.cu (unpack kernels): (B, l_max) int32 codes,
    ambiguous bases 4, from 2-bit reads on the card."""
    dev = words.device
    B = words.shape[0]
    _check("words", words, torch.int32, (B, -(-l_max // 16)), dev)
    n_amb = amb_r.shape[0]
    _check("amb_r", amb_r, torch.int32, (n_amb,), dev)
    _check("amb_p", amb_p, torch.int32, (n_amb,), dev)
    out = torch.empty((B, l_max), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.kart_unpack_reads(words.data_ptr(), amb_r.data_ptr(), amb_p.data_ptr(), n_amb,
                                   B, l_max, out.data_ptr(), _stream(dev))
    _raise_on(rc, "unpack_reads")
    unpack_reads.launches += 1
    return out


unpack_reads.launches = 0


def resolve_pack(sa_full, packed, *, max_seeds: int, has_ok: bool, occ_budget: int,
                 pack16: bool):
    """csrc/resolve_pack.cu: the packed int32 resolved stream of a packed
    seed array on the card (the funnel's, has_ok, or the FM stepper's)."""
    dev = packed.device
    B = packed.shape[0]
    H = int(occ_budget)
    _check("packed", packed, torch.int32, (B, 1 + int(has_ok) + 4 * max_seeds), dev)
    _check("sa_full", sa_full, torch.int32, (sa_full.shape[0],), dev)
    if pack16 and (B % 2 or H % 2):
        raise ValueError(f"pack16 needs an even batch and budget, got B={B} H={H}")
    n = (B // 2 + H // 2 + H) if pack16 else (B + 2 * H)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    read_end = torch.empty((B,), dtype=torch.int32, device=dev)
    cnts = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = _load()
    scan_state = torch.empty((lib.kart_resolve_scan_words(B),), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.kart_resolve_pack(
            packed.data_ptr(), B, int(has_ok), max_seeds, sa_full.data_ptr(), H, int(pack16),
            read_end.data_ptr(), cnts.data_ptr(), scan_state.data_ptr(), out.data_ptr(),
            _stream(dev),
        )
    _raise_on(rc, "resolve_pack")
    resolve_pack.launches += 1
    return out


resolve_pack.launches = 0


def row_gather(table, rid):
    """csrc/row_gather.cu: (HR, 128) int32 rows table[rid] of a (NR, 128)
    int32 table on the card, for (HR,) int32 row ids in [0, NR).  A launch
    recorded into a CUDA graph is not counted here: whoever replays the
    graph counts its launches."""
    dev = table.device
    nr = table.shape[0]
    n = rid.shape[0]
    _check("table", table, torch.int32, (nr, 128), dev, align=16)
    _check("rid", rid, torch.int32, (n,), dev)
    out = torch.empty((n, 128), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.kart_row_gather(table.data_ptr(), rid.data_ptr(), n, out.data_ptr(), _stream(dev))
    _raise_on(rc, "row_gather")
    if not torch.cuda.is_current_stream_capturing():
        row_gather.launches += 1
    return out


row_gather.launches = 0
