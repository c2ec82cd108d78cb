"""Build and binding of the port's CUDA kernels.

`nvcc` compiles each `csrc/*.cu` for sm_90a (all sources at once, one
process each) and links them into one shared library with a plain C
interface, `_build/libkarttorch.so`, at first use (and again whenever a
source, or a header the sources include, is newer than the library).  The
library is loaded with ctypes.  Each wrapper checks its tensors, allocates
its outputs with `torch.empty`, launches on the current CUDA stream, raises
if the launch reports an error, and counts its launches in a plain integer
attribute (`.launches`).

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
    for f in ("fm_seed_scan.cu", "nw.cu", "kmer_funnel.cu", "resolve_pack.cu", "row_gather.cu",
              "sa_walk.cu", "cluster.cu", "pairing.cu", "sharded_fm.cu", "sorted_occ.cu")
)
# included by the sources
HEADERS = tuple(os.path.join(_PKG, "csrc", f) for f in ("window.cuh", "fm_index.cuh"))
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libkarttorch.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# positions (one a base of a read) a tile of the SensitiveMode kernels'
# position-parallel pass holds, 8 bytes each in either kernel's scratch (64 MB);
# the funnel's tile holds at least one whole slab
SENS_SCRATCH = 1 << 23
# lanes of a SensitiveMode funnel slab: four a thread of the replay's block
# (kSlabMax of csrc/kmer_funnel.cu)
FUNNEL_SLAB_MAX = 4096

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
    newest = max(os.path.getmtime(s) for s in (*sources, *HEADERS))
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
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name, prim in (("", i), ("_i64", ll)):
            fn = getattr(lib, "kart_fm_seed_scan" + name)
            fn.argtypes = [p, p, p, prim, p, p, i, i, i, i, p, p]
            fn.restype = i
            fn = getattr(lib, "kart_fm_sensitive_scan" + name)
            fn.argtypes = [p, p, p, prim, p, p, i, i, i, i, i, p, ll, p, p]
            fn.restype = i
            fn = getattr(lib, "kart_sa_walk" + name)
            fn.argtypes = [p, p, p, p, prim, p, i, i, p, p, p]
            fn.restype = i
            fn = getattr(lib, "kart_sharded_seed_scan" + name)
            fn.argtypes = [p, i, ll, p, prim, p, p, i, i, i, i, p, p]
            fn.restype = i
            fn = getattr(lib, "kart_sharded_sa_walk" + name)
            fn.argtypes = [p, i, ll, ll, p, prim, p, i, i, p, p, p]
            fn.restype = i
            fn = getattr(lib, "kart_sharded_occ4" + name)
            fn.argtypes = [p, i, ll, prim, p, i, p, p]
            fn.restype = i
            fn = getattr(lib, "kart_sharded_fused_step" + name)
            fn.argtypes = [p, i, ll, p, i, p, p, p, p, prim, i, i, i, i, i, p, p, p, p, p, p, p]
            fn.restype = i
            fn = getattr(lib, "kart_sharded_inv_psi" + name)
            fn.argtypes = [p, i, ll, p, prim, p, i, p, p, p]
            fn.restype = i
            fn = getattr(lib, "kart_sharded_gather" + name)
            fn.argtypes = [p, i, ll, p, i, i, p, p]
            fn.restype = i
            fn = getattr(lib, "kart_sorted_occurrences" + name)
            fn.argtypes = [p, i, p, p, ll, i, p, p, p, p, p, p, p, p]
            fn.restype = i
        lib.kart_nw_planes.argtypes = [p, p, i, i, p, p]
        lib.kart_nw_planes.restype = i
        lib.kart_kmer_funnel.argtypes = [p, p, p, p, i, p, p, p, i, p, i, i, i, i, i, i, i, i, i,
                                         p, p, ctypes.c_longlong, p, p, p, p]
        lib.kart_kmer_funnel.restype = i
        lib.kart_kmer_funnel_cluster.argtypes = []
        lib.kart_kmer_funnel_cluster.restype = i
        lib.kart_unpack_reads.argtypes = [p, p, p, i, i, i, p, p]
        lib.kart_unpack_reads.restype = i
        lib.kart_resolve_pack.argtypes = [p, i, i, i, p, i, i, p, p, p, p, p]
        lib.kart_resolve_pack.restype = i
        for name in ("", "_i64"):
            fn = getattr(lib, "kart_resolve_rows" + name)
            fn.argtypes = [p, i, i, i, p, i, p, p, p, p, p, p, p]
            fn.restype = i
        lib.kart_resolve_finish.argtypes = [p, i, i, i, i, i, p, p, p, p, p, p, p]
        lib.kart_resolve_finish.restype = i
        lib.kart_resolve_finish_i64.argtypes = [p, i, i, i, i, p, p, p, p, p, p, p]
        lib.kart_resolve_finish_i64.restype = i
        lib.kart_resolve_scan_words.argtypes = [i]
        lib.kart_resolve_scan_words.restype = i
        lib.kart_resolve_pack_table.argtypes = [p, i, i, p, i, ll, i, p, p, p, p, p]
        lib.kart_resolve_pack_table.restype = i
        lib.kart_resolve_rows_table_i64.argtypes = [p, i, i, p, i, ll, i, p, p, p, p, p, p]
        lib.kart_resolve_rows_table_i64.restype = i
        lib.kart_sorted_occ_state_words.argtypes = [i]
        lib.kart_sorted_occ_state_words.restype = i
        lib.kart_row_gather.argtypes = [p, p, i, p, p]
        lib.kart_row_gather.restype = i
        lib.kart_cluster_illumina.argtypes = [p, i, p, p, p, p, p, i, i, i, p, p, p, p]
        lib.kart_cluster_illumina.restype = i
        lib.kart_pair_candidates.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p]
        lib.kart_pair_candidates.restype = i
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


# block numbers are 32-bit in fm_index.cuh's FlatIndex
FLAT_MAX_TEXT = 1 << 39


def _check_fm(fm, dev) -> tuple[torch.dtype, str]:
    """Check an FMIndexTensors on the card; returns its index dtype and the
    suffix of the C entries of that type ("" for int32, "_i64")."""
    idt = fm.index_dtype
    if idt not in (torch.int32, torch.int64):
        raise TypeError(f"FM index: expected an int32 or int64 index, got {idt}")
    if fm.seq_len >= FLAT_MAX_TEXT:
        raise ValueError(f"FM index: {fm.seq_len} text rows, the kernels take fewer than 2**39")
    n_blocks = fm.occ_cp.numel() // 4
    _check("occ_cp", fm.occ_cp, idt, (4 * n_blocks,), dev, align=16)
    _check("bwt_words", fm.bwt_words, torch.int32, (8 * n_blocks,), dev, align=16)
    _check("L2", fm.L2, idt, (5,), dev)
    _check("sa_samples", fm.sa_samples, idt, (fm.sa_samples.shape[0],), dev)
    return idt, "" if idt == torch.int32 else "_i64"


def fm_seed_scan(fm, reads, rlens, min_seed_len: int, *, max_seeds: int, l_max: int):
    """csrc/fm_seed_scan.cu: packed FastMode seeds (B, 1 + 4*max_seeds) in
    the index dtype (int32, or int64) for reads (B, l_max) int32 and rlens
    (B,) int32 on the card.  A group of 16 lanes steps each read; the launch
    is refused where a block's reads of l_max bases exceed its shared
    memory (l_max in the tens of thousands)."""
    dev = reads.device
    B = reads.shape[0]
    _check("reads", reads, torch.int32, (B, l_max), dev)
    _check("rlens", rlens, torch.int32, (B,), dev)
    idt, sfx = _check_fm(fm, dev)
    out = torch.empty((B, 1 + 4 * max_seeds), dtype=idt, device=dev)
    if B == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, "kart_fm_seed_scan" + sfx)(
            fm.occ_cp.data_ptr(), fm.bwt_words.data_ptr(), fm.L2.data_ptr(),
            int(fm.primary), reads.data_ptr(), rlens.data_ptr(), B, l_max,
            int(min_seed_len), int(max_seeds), out.data_ptr(), stream,
        )
    _raise_on(rc, "fm_seed_scan")
    fm_seed_scan.launches += 1
    return out


fm_seed_scan.launches = 0


def sens_scratch_rows(B: int, width: int) -> int:
    """Reads a tile of the SensitiveMode FM stepper's extension pass
    holds: as many of the B reads of `width` positions as SENS_SCRATCH
    positions take.  Raises where one read alone exceeds them."""
    if width > SENS_SCRATCH:
        raise ValueError(f"SensitiveMode scratch: a read of {width} positions exceeds the"
                         f" {SENS_SCRATCH} positions a tile holds")
    return max(1, min(B, SENS_SCRATCH // max(width, 1)))


def funnel_tile_rows(B: int, l_max: int, slab_rows: int) -> int:
    """Reads a tile of the SensitiveMode funnel's position-parallel pass
    holds: whole slabs of min(B, slab_rows) rows, as many as SENS_SCRATCH
    positions take and at least one (a 640-read group at l_max 32768 is one
    tile of 168 MB).  Raises where a slab holds more than FUNNEL_SLAB_MAX
    rows, which the replay cannot take."""
    slab = min(B, slab_rows)
    if slab > FUNNEL_SLAB_MAX:
        raise ValueError(f"SensitiveMode kmer_funnel: a slab of {slab} rows exceeds the"
                         f" {FUNNEL_SLAB_MAX} lanes its replay holds (slab_rows {slab_rows})")
    return min(B, max(1, SENS_SCRATCH // (slab * l_max)) * slab)


def fm_sensitive_scan(fm, reads, rlens, min_seed_len: int, *, max_seeds: int, l_max: int):
    """csrc/fm_seed_scan.cu (fm_extend_kernel, fm_chase_kernel): packed
    SensitiveMode seeds (B, 1 + 4*max_seeds) in the index dtype for reads
    (B, width) int32 and rlens (B,) int32 on the card.  Every start of every read is
    extended in parallel, then a warp a read chains the extensions;
    reads go through in tiles of sens_scratch_rows(B, width).  `l_max` sets
    the trip limit, 31 * (l_max // min_seed_len + 2), as in kart_tpu."""
    dev = reads.device
    B, width = reads.shape
    _check("reads", reads, torch.int32, (B, width), dev)
    _check("rlens", rlens, torch.int32, (B,), dev)
    idt, sfx = _check_fm(fm, dev)
    out = torch.empty((B, 1 + 4 * max_seeds), dtype=idt, device=dev)
    if B == 0:
        return out
    cap = sens_scratch_rows(B, width) * width
    ext = torch.empty((cap, 2), dtype=idt, device=dev)  # an int2 or longlong2 a position
    max_trips = 31 * (l_max // max(int(min_seed_len), 1) + 2)
    lib = _load()
    with torch.cuda.device(dev):
        rc = getattr(lib, "kart_fm_sensitive_scan" + sfx)(
            fm.occ_cp.data_ptr(), fm.bwt_words.data_ptr(), fm.L2.data_ptr(),
            int(fm.primary), reads.data_ptr(), rlens.data_ptr(), B, width,
            int(min_seed_len), int(max_seeds), max_trips, ext.data_ptr(), cap, out.data_ptr(),
            _stream(dev),
        )
    _raise_on(rc, "fm_sensitive_scan")
    fm_sensitive_scan.launches += 1
    return out


fm_sensitive_scan.launches = 0


def nw_planes(c1, c2, *, lm: int):
    """csrc/nw.cu: (N, lm+1, lm+1) uint8 NW decision planes for (N, lm)
    int8 code pairs on the card, lm in (16, 32, 64, 128): a wavefront across
    the lanes of a warp or half-warp per pair."""
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
                l_max: int, hit_cap: int, rounds: int, slab_rows: int, hit_budget: int,
                sensitive: bool = False):
    """csrc/kmer_funnel.cu: packed funnel seeds (B, 2 + 4*max_seeds) int32
    for 2-bit reads on the card (words (B, ceil(l_max/16)) int32 bits,
    amb_r/amb_p (n_amb,) int32, rlens (B,) int32), against the tables of a
    KmerTablesTensors: FastMode with l_max <= 512, or SensitiveMode
    (`sensitive`, at least 4 hits a row and round) with l_max <= 32768.
    FastMode runs one thread-block cluster per slab of min(B, slab_rows)
    rows.  SensitiveMode evaluates a round at every restart position of
    every lane over the whole card (in tiles of funnel_tile_rows(B, l_max,
    slab_rows) rows), chains each lane's rounds, and replays round by round
    the slabs where some round's hits overran the budget; the slabs of each
    path are counted on the card (funnel_slab_paths)."""
    from .ops.kmer_seed import check_l_max

    check_l_max(l_max, sensitive)
    if sensitive:
        hit_budget = max(hit_budget, 4)
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
    scr = totals = paths = None
    cap = 0
    if sensitive:
        n_slabs = -(-B // min(B, slab_rows))
        cap = funnel_tile_rows(B, l_max, slab_rows) * l_max
        scr = torch.empty((cap, 2), dtype=torch.int32, device=dev)
        totals = torch.empty((n_slabs * rounds,), dtype=torch.int32, device=dev)
        paths = _slab_paths(dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.kart_kmer_funnel(
            tt.table_lo.data_ptr(), tt.sub_tbl.data_ptr(), tt.sa_full.data_ptr(),
            tt.text_words.data_ptr(), tt.seq_len,
            words.data_ptr(), amb_r.data_ptr(), amb_p.data_ptr(), n_amb, rlens.data_ptr(),
            B, l_max, int(min_seed_len), max_seeds, hit_cap, rounds, slab_rows, hit_budget,
            int(sensitive), ambm.data_ptr(), ptr(scr), cap, ptr(totals), ptr(paths),
            out.data_ptr(), _stream(dev),
        )
    _raise_on(rc, "kmer_funnel")
    kmer_funnel.launches += 1
    return out


_SLAB_PATHS: dict = {}


def _slab_paths(dev) -> torch.Tensor:
    """The device's two SensitiveMode slab counters, made at first use."""
    key = str(dev)
    if key not in _SLAB_PATHS:
        _SLAB_PATHS[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _SLAB_PATHS[key]


def funnel_slab_paths(dev, reset: bool = False) -> tuple[int, int]:
    """SensitiveMode slabs that kmer_funnel ran on `dev` (a CUDA tensor's
    device) since the counters were last reset, by path: (chased exactly,
    replayed round by round).  Reads the counters from the card; `reset` then sets
    them to 0."""
    t = _slab_paths(dev)
    chased, sync = (int(x) for x in t.tolist())
    if reset:
        t.zero_()
    return chased, sync


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
                 pack16: bool, fm=None, max_steps: int = 4096):
    """csrc/resolve_pack.cu: the resolved stream of a packed seed array on
    the card (the funnel's, has_ok, or the FM stepper's), through the full
    SA sa_full or, where sa_full is None, through the sampled SA of fm: the
    rows of the stream's slots are walked by csrc/sa_walk.cu's kernel
    (counted in sa_walk.launches), and a walk cut at max_steps flags its
    read.  Seeds and positions in int32 give one int32 array; in int64 (an
    int64 index) the tuple (cnts, meta, gpos) in the 32-bit layout, gpos
    int64."""
    dev = packed.device
    B = packed.shape[0]
    H = int(occ_budget)
    pdt = packed.dtype
    if pdt not in (torch.int32, torch.int64):
        raise TypeError(f"packed: expected int32 or int64 seeds, got {pdt}")
    _check("packed", packed, pdt, (B, 1 + int(has_ok) + 4 * max_seeds), dev)
    if sa_full is not None:
        _check("sa_full", sa_full, pdt, (sa_full.shape[0],), dev)
    else:
        if fm is None:
            raise ValueError("resolve_pack: neither a full SA nor an FM index to walk")
        if _check_fm(fm, dev)[0] != pdt:
            raise TypeError(f"resolve_pack: {pdt} seeds on an {fm.index_dtype} index")
    wide = pdt == torch.int64
    if pack16 and (wide or B % 2 or H % 2):
        raise ValueError(f"pack16 needs int32 seeds, an even batch and budget, got {pdt} B={B}"
                         f" H={H}")
    if not wide and sa_full is not None:  # one call: totals, then emit with the gather
        out = torch.empty(((B // 2 + H // 2 + H) if pack16 else (B + 2 * H),), dtype=torch.int32,
                          device=dev)
        read_end = torch.empty((B,), dtype=torch.int32, device=dev)
        cnts = torch.empty((B,), dtype=torch.int32, device=dev)
        lib = _load()
        scan_state = torch.empty((lib.kart_resolve_scan_words(B),), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            rc = lib.kart_resolve_pack(packed.data_ptr(), B, int(has_ok), max_seeds,
                                       sa_full.data_ptr(), H, int(pack16), read_end.data_ptr(),
                                       cnts.data_ptr(), scan_state.data_ptr(), out.data_ptr(),
                                       _stream(dev))
        _raise_on(rc, "resolve_pack")
    else:
        def walk(rows, gpos, done):
            _walk(fm, rows, max_steps, gpos, done)

        out = _resolve_by_rows(packed, has_ok, max_seeds, H, pack16, sa_full,
                               walk if sa_full is None else None)
    resolve_pack.launches += 1
    return out


def _resolve_by_rows(packed, has_ok: bool, max_seeds: int, H: int, pack16: bool, sa_full, fill,
                     table=None):
    """resolve_pack.cu's passes around an SA lookup: the memset, totals and
    rows, then the positions (an int64 full SA's gather in the rows pass,
    flat or through `table`, (shard table, ns_local), or fill(rows, gpos,
    done), which writes each slot's text position and whether it resolved),
    then flag (with fill) and emit.  Returns the int32 stream, or for int64
    seeds the (cnts, meta, gpos) tuple."""
    dev = packed.device
    B = packed.shape[0]
    wide = packed.dtype == torch.int64
    n = (B // 2 + H // 2 + H) if pack16 else (B + H if wide else B + 2 * H)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    read_end = torch.empty((B,), dtype=torch.int32, device=dev)
    cnts = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = _load()
    scan_state = torch.empty((lib.kart_resolve_scan_words(B),), dtype=torch.int64, device=dev)
    head = (packed.data_ptr(), B, int(has_ok), max_seeds)
    # the positions: their own int64 array, or the int32 stream's last H words
    gpos = torch.empty((H,), dtype=torch.int64, device=dev) if wide else out[n - H:]
    slot_read = torch.empty((H,), dtype=torch.int32, device=dev)
    rows = torch.empty((H,), dtype=packed.dtype, device=dev) if fill is not None else None
    done = torch.empty((H,), dtype=torch.bool, device=dev) if fill is not None else None
    sfx = "_i64" if wide else ""
    with torch.cuda.device(dev):
        if table is not None:
            rc = lib.kart_resolve_rows_table_i64(
                packed.data_ptr(), B, max_seeds, table[0].data_ptr(), table[0].shape[0],
                int(table[1]), H,
                read_end.data_ptr(), cnts.data_ptr(), scan_state.data_ptr(),
                slot_read.data_ptr(), gpos.data_ptr(), _stream(dev))
        else:
            rc = getattr(lib, "kart_resolve_rows" + sfx)(
                *head, None if sa_full is None else sa_full.data_ptr(), H, read_end.data_ptr(),
                cnts.data_ptr(), scan_state.data_ptr(), None if rows is None else rows.data_ptr(),
                slot_read.data_ptr(), gpos.data_ptr(), _stream(dev))
        _raise_on(rc, "resolve_pack")
        if fill is not None and H:
            fill(rows, gpos, done)
        tail = (None if done is None else done.data_ptr(), gpos.data_ptr(), out.data_ptr(),
                _stream(dev))
        if wide:
            rc = lib.kart_resolve_finish_i64(*head, H, read_end.data_ptr(), cnts.data_ptr(),
                                             slot_read.data_ptr(), *tail)
        else:
            rc = lib.kart_resolve_finish(*head, H, int(pack16), read_end.data_ptr(),
                                         cnts.data_ptr(), slot_read.data_ptr(), *tail)
        _raise_on(rc, "resolve_pack")
    if wide:
        return out[:B], out[B:], gpos
    return out


def resolve_stream(packed, fill, *, max_seeds: int, occ_budget: int):
    """csrc/resolve_pack.cu through an SA lookup of the caller's (the
    sharded index's, parallel/sharded_index.py): (cnts, meta, gpos) of a
    packed FM-stepper seed array (B, 1 + 4*max_seeds) on the card in the
    32-bit layout, gpos in the seeds' dtype.  fill(rows, gpos, done) gets
    each stream slot's SA row (row 0 past the last read) and writes its text
    position and whether it resolved; a slot not resolved flags its read.
    Counted in resolve_pack.launches."""
    dev = packed.device
    B = packed.shape[0]
    H = int(occ_budget)
    pdt = packed.dtype
    if pdt not in (torch.int32, torch.int64):
        raise TypeError(f"packed: expected int32 or int64 seeds, got {pdt}")
    _check("packed", packed, pdt, (B, 1 + 4 * max_seeds), dev)
    out = _resolve_by_rows(packed, False, max_seeds, H, False, None, fill)
    resolve_pack.launches += 1
    if isinstance(out, tuple):
        return out
    return out[:B], out[B:B + H], out[B + H:]


def resolve_stream_table(table, ns_local: int, packed, *, max_seeds: int, occ_budget: int):
    """csrc/resolve_pack.cu through the full SA split over the shards of the
    seeds' device (the resident full-SA resolve): (cnts, meta, gpos) as
    resolve_stream's, each slot's position read from its owner's slab
    through the shard table of every shard (table (N, 4) int64, its
    `has_full_sa`: every row's sa_full slab set; ns_local rows a slab).
    int32 seeds: the memset, totals and emit, as resolve_pack's flat call
    (kart_resolve_pack_table); int64: the memset, totals, the rows pass
    writing the positions, and emit (kart_resolve_rows_table_i64, then
    kart_resolve_finish_i64).  No SA lookup of the caller's, no sum, no copy.
    Counted in resolve_pack.launches."""
    if not (getattr(table, "every_shard", False) and getattr(table, "has_full_sa", False)):
        raise ValueError("resolve_stream_table: needs the shard table of every shard, each with"
                         " its full-SA slab (sharded_index.shard_table of all the shards, full SA)")
    if int(ns_local) < 1:
        raise ValueError(f"resolve_stream_table: ns_local {ns_local}")
    dev = packed.device
    B = packed.shape[0]
    H = int(occ_budget)
    pdt = packed.dtype
    if pdt not in (torch.int32, torch.int64):
        raise TypeError(f"packed: expected int32 or int64 seeds, got {pdt}")
    _check("packed", packed, pdt, (B, 1 + 4 * max_seeds), dev)
    _check("table", table, torch.int64, (table.shape[0], 4), dev, align=16)
    if pdt == torch.int64:
        out = _resolve_by_rows(packed, False, max_seeds, H, False, None, None,
                               table=(table, ns_local))
    else:
        out = torch.empty((B + 2 * H,), dtype=torch.int32, device=dev)
        read_end = torch.empty((B,), dtype=torch.int32, device=dev)
        cnts = torch.empty((B,), dtype=torch.int32, device=dev)
        lib = _load()
        scan_state = torch.empty((lib.kart_resolve_scan_words(B),), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            rc = lib.kart_resolve_pack_table(packed.data_ptr(), B, max_seeds, table.data_ptr(),
                                             table.shape[0], int(ns_local), H,
                                             read_end.data_ptr(), cnts.data_ptr(),
                                             scan_state.data_ptr(), out.data_ptr(), _stream(dev))
        _raise_on(rc, "resolve_pack")
        out = out[:B], out[B:B + H], out[B + H:]
    resolve_pack.launches += 1
    return out


resolve_pack.launches = 0


def _walk(fm, rows, max_steps: int, pos, done) -> None:
    """Launch csrc/sa_walk.cu's kernel on rows (n,) of the index dtype, into
    pos (n,) of that dtype and done (n,) bool, all on the card."""
    n = rows.shape[0]
    lib = _load()
    sfx = "" if fm.index_dtype == torch.int32 else "_i64"
    with torch.cuda.device(rows.device):
        rc = getattr(lib, "kart_sa_walk" + sfx)(
            fm.occ_cp.data_ptr(), fm.bwt_words.data_ptr(), fm.L2.data_ptr(),
            fm.sa_samples.data_ptr(), int(fm.primary), rows.data_ptr(), n, int(max_steps),
            pos.data_ptr(), done.data_ptr(), _stream(rows.device))
    _raise_on(rc, "sa_walk")
    sa_walk.launches += 1


def sa_walk(fm, rows, *, max_steps: int = 4096):
    """csrc/sa_walk.cu: (pos, done) of the sampled-SA walk of rows (N,) on
    the card, a thread a row: pos = steps + sa_samples[row >> 5] also where
    max_steps cut the walk, done (bool) where it reached a sample.  Rows are
    walked in the index dtype; pos comes back in the wider of the rows' and
    the index's dtype, as the plain version's."""
    dev = rows.device
    n = rows.shape[0]
    if rows.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"rows: expected int32 or int64, got {rows.dtype}")
    idt, _ = _check_fm(fm, dev)
    k = rows.to(idt).contiguous()
    _check("rows", k, idt, (n,), dev)
    pos = torch.empty((n,), dtype=idt, device=dev)
    done = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        _walk(fm, k, max_steps, pos, done)
    return pos.to(torch.promote_types(rows.dtype, idt)), done


sa_walk.launches = 0


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


def cluster_illumina(chr_keys, pd, gp, ln, n_seeds, thr0, max_gaps: int, *, max_seeds: int):
    """csrc/cluster.cu: (cluster_id (B, S) int32, accept (B, S) bool, scores
    (B, S) int32) of the seed clustering, for chr_keys (K,) int32, pd, gp,
    ln (B, S) int32 and n_seeds, thr0 (B,) int32 on the card, S = max_seeds:
    a warp a read."""
    dev = pd.device
    B, S = pd.shape
    if S != max_seeds:
        raise ValueError(f"cluster_illumina: {S} seed slots, max_seeds {max_seeds}")
    K = chr_keys.shape[0]
    _check("chr_keys", chr_keys, torch.int32, (K,), dev)
    for name, t in (("pd", pd), ("gp", gp), ("ln", ln)):
        _check(name, t, torch.int32, (B, S), dev)
    _check("n_seeds", n_seeds, torch.int32, (B,), dev)
    _check("thr0", thr0, torch.int32, (B,), dev)
    cluster_id = torch.empty((B, S), dtype=torch.int32, device=dev)
    accept = torch.empty((B, S), dtype=torch.bool, device=dev)
    scores = torch.empty((B, S), dtype=torch.int32, device=dev)
    if B == 0 or S == 0:
        return cluster_id, accept, scores
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.kart_cluster_illumina(
            chr_keys.data_ptr(), K, pd.data_ptr(), gp.data_ptr(), ln.data_ptr(),
            n_seeds.data_ptr(), thr0.data_ptr(), int(max_gaps), B, S, cluster_id.data_ptr(),
            accept.data_ptr(), scores.data_ptr(), _stream(dev))
    _raise_on(rc, "cluster_illumina")
    if not torch.cuda.is_current_stream_capturing():
        cluster_illumina.launches += 1
    return cluster_id, accept, scores


cluster_illumina.launches = 0


def pair_candidates(score1, pd1, score2, pd2, est: int):
    """csrc/pairing.cu: (paired1 (P, C1) int32, paired2 (P, C2) int32,
    pairing (P,) bool) of the paired-end mating, for score1/pd1 (P, C1) and
    score2/pd2 (P, C2) int32 on the card: a warp a pair."""
    dev = score1.device
    P, C1 = score1.shape
    C2 = score2.shape[1]
    _check("score1", score1, torch.int32, (P, C1), dev)
    _check("pd1", pd1, torch.int32, (P, C1), dev)
    _check("score2", score2, torch.int32, (P, C2), dev)
    _check("pd2", pd2, torch.int32, (P, C2), dev)
    paired1 = torch.empty((P, C1), dtype=torch.int32, device=dev)
    paired2 = torch.empty((P, C2), dtype=torch.int32, device=dev)
    pairing = torch.empty((P,), dtype=torch.bool, device=dev)
    if P == 0:
        return paired1, paired2, pairing
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.kart_pair_candidates(
            score1.data_ptr(), pd1.data_ptr(), score2.data_ptr(), pd2.data_ptr(), int(est), P, C1,
            C2, paired1.data_ptr(), paired2.data_ptr(), pairing.data_ptr(), _stream(dev))
    _raise_on(rc, "pair_candidates")
    if not torch.cuda.is_current_stream_capturing():
        pair_candidates.launches += 1
    return paired1, paired2, pairing


pair_candidates.launches = 0


# ---------------------------------------------------------------------------
# The sharded FM index through its shard table (parallel/sharded_index.py):
# the resident scan and walk (csrc/fm_seed_scan.cu, csrc/sa_walk.cu), the
# cross-device step kernels (csrc/sharded_fm.cu)
# ---------------------------------------------------------------------------

# block numbers and sample rows are 32-bit in the table kernels (fm_index.cuh)
SHARDED_MAX_TEXT = 1 << 37


def _index_sfx(t: torch.Tensor) -> str:
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"sharded index: expected an int32 or int64 index, got {t.dtype}")
    return "" if t.dtype == torch.int32 else "_i64"


def _count(fn) -> None:
    """One launch of fn's kernel; a launch recorded into a CUDA graph is
    counted by whoever replays the graph."""
    if not torch.cuda.is_current_stream_capturing():
        fn.launches += 1


def _check_table(table, L2, seq_len: int, dev, every_shard: bool = False
                 ) -> tuple[torch.dtype, str]:
    """Check a shard table (N, 4) int64 of slab pointers and the index's L2
    on dev, with every shard's row filled where `every_shard` (a resident
    kernel reads each row without a look at it; sharded_index.shard_table
    records whether a table is whole); returns the index dtype and the C
    entries' suffix."""
    if every_shard and not getattr(table, "every_shard", False):
        raise ValueError("shard table: a resident kernel needs a table of every shard"
                         " (sharded_index.shard_table of all the shards)")
    sfx = _index_sfx(L2)
    _check("table", table, torch.int64, (table.shape[0], 4), dev, align=16)
    _check("L2", L2, L2.dtype, (5,), dev)
    if table.shape[0] < 1:
        raise ValueError("shard table: no shards")
    if seq_len >= SHARDED_MAX_TEXT:
        raise ValueError(f"sharded index: {seq_len} text rows, the table kernels take fewer than"
                         f" 2**37")
    return L2.dtype, sfx


def sharded_seed_scan(table, nb_local: int, L2, primary: int, seq_len: int, reads, rlens,
                      min_seed_len: int, *, max_seeds: int, l_max: int):
    """csrc/fm_seed_scan.cu through the shard table (the resident scan):
    packed FastMode seeds (B, 1 + 4*max_seeds) in the index dtype, as
    fm_seed_scan's, for reads (B, l_max) int32 and rlens (B,) int32, with
    every shard's slabs on the reads' device: table (N, 4) int64, each row a
    shard's occ_cp, bwt_words, sa_samples and sa_full pointers there (a
    table with a null row raises; sa_full is null in the sampled SA mode);
    nb_local blocks a slab.  One launch for the whole
    scan."""
    dev = reads.device
    B = reads.shape[0]
    idt, sfx = _check_table(table, L2, seq_len, dev, every_shard=True)
    _check("reads", reads, torch.int32, (B, l_max), dev)
    _check("rlens", rlens, torch.int32, (B,), dev)
    out = torch.empty((B, 1 + 4 * max_seeds), dtype=idt, device=dev)
    if B == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        rc = getattr(lib, "kart_sharded_seed_scan" + sfx)(
            table.data_ptr(), table.shape[0], int(nb_local), L2.data_ptr(), int(primary),
            reads.data_ptr(), rlens.data_ptr(), B, l_max, int(min_seed_len), int(max_seeds),
            out.data_ptr(), _stream(dev))
    _raise_on(rc, "sharded_seed_scan")
    _count(sharded_seed_scan)
    return out


sharded_seed_scan.launches = 0


def sharded_sa_walk(table, nb_local: int, nsamp_local: int, L2, primary: int, seq_len: int, rows,
                    *, max_steps: int = 4096):
    """csrc/sa_walk.cu through the shard table (the resident walk): (pos,
    done) of the sampled-SA walk of rows (n,) of the index dtype, as
    sa_walk's, every shard's slabs on the rows' device (table as
    sharded_seed_scan's; nsamp_local sampled rows a slab), the sample at a
    walk's end read from its owner's slab.  One launch."""
    dev = rows.device
    n = rows.shape[0]
    idt, sfx = _check_table(table, L2, seq_len, dev, every_shard=True)
    _check("rows", rows, idt, (n,), dev)
    pos = torch.empty((n,), dtype=idt, device=dev)
    done = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return pos, done
    lib = _load()
    with torch.cuda.device(dev):
        rc = getattr(lib, "kart_sharded_sa_walk" + sfx)(
            table.data_ptr(), table.shape[0], int(nb_local), int(nsamp_local), L2.data_ptr(),
            int(primary), rows.data_ptr(), n, int(max_steps), pos.data_ptr(), done.data_ptr(),
            _stream(dev))
    _raise_on(rc, "sharded_sa_walk")
    _count(sharded_sa_walk)
    return pos, done


sharded_sa_walk.launches = 0


def sharded_occ4(table, nb_local: int, L2, primary: int, seq_len: int, k, out=None):
    """csrc/sharded_fm.cu (G1): (n, 4) occ4 counts of the rows k (n,) on the
    card from the owners' blocks that the shard table (as sharded_seed_scan's,
    null rows for the shards on other devices) holds, zeros for the other
    rows, into `out` where given.  One launch answers for every shard of the
    device."""
    dev = k.device
    n = k.shape[0]
    idt, sfx = _check_table(table, L2, seq_len, dev)
    _check("k", k, idt, (n,), dev)
    if out is None:
        out = torch.empty((n, 4), dtype=idt, device=dev)
    _check("out", out, idt, (n, 4), dev)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        rc = getattr(lib, "kart_sharded_occ4" + sfx)(
            table.data_ptr(), table.shape[0], int(nb_local), int(primary), k.data_ptr(), n,
            out.data_ptr(), _stream(dev))
    _raise_on(rc, "sharded_occ4")
    _count(sharded_occ4)
    return out


sharded_occ4.launches = 0


def part_pointers(parts) -> torch.Tensor | None:
    """The device array of the parts' data pointers that sharded_fused_step
    reads them through: (len(parts),) int64 on their device, its `ptrs` the
    pointers it holds (the wrapper checks them against the parts it is
    given).  Made once for buffers that a loop reuses."""
    if not parts:
        return None
    ptrs = tuple(t.data_ptr() for t in parts)
    arr = torch.tensor(ptrs, dtype=torch.int64).to(parts[0].device)
    arr.ptrs = ptrs
    return arr


def sharded_fused_step(table, nb_local: int, L2, primary: int, seq_len: int, k, parts, part_ptrs,
                       p: int, codes_t, rlens, min_seed_len: int, max_seeds: int, state,
                       state_out, out, k_next) -> None:
    """csrc/sharded_fm.cu (G2 fused with this device's G1): one FastMode step
    of every lane on the card: occ4 of the rows k (2B,) through the shard
    table of this device's shards (as sharded_occ4's), plus `parts`, the
    other devices' occ4 of k moved here ((2B, 4) each, read through
    part_ptrs, `part_pointers` of them, or None where there are none), then
    ops/fm_search.py::seed_scan_step_plain's step on the sums: codes_t
    (l_max, B) int32, rlens (B,) int32, state (ist (3, B) int32, tst (3,
    B)) in, state_out the same out (another pair of buffers), out (B, 1 +
    4*max_seeds) written in place, k_next (2B,) the next step's rows."""
    ist, tst = state
    dev = k.device
    B = ist.shape[1]
    l_max = codes_t.shape[0]
    idt, sfx = _check_table(table, L2, seq_len, dev)
    _check("k", k, idt, (2 * B,), dev)
    for j, part in enumerate(parts):
        _check(f"parts[{j}]", part, idt, (2 * B, 4), dev, align=16)
    if parts and getattr(part_ptrs, "ptrs", None) != tuple(t.data_ptr() for t in parts):
        raise ValueError("sharded_fused_step: part_ptrs is not part_pointers(parts)")
    _check("codes_t", codes_t, torch.int32, (l_max, B), dev)
    _check("rlens", rlens, torch.int32, (B,), dev)
    _check("ist", ist, torch.int32, (3, B), dev)
    _check("tst", tst, idt, (3, B), dev)
    _check("ist_out", state_out[0], torch.int32, (3, B), dev)
    _check("tst_out", state_out[1], idt, (3, B), dev)
    _check("out", out, idt, (B, 1 + 4 * max_seeds), dev)
    _check("k_next", k_next, idt, (2 * B,), dev)
    if B == 0:
        return
    lib = _load()
    with torch.cuda.device(dev):
        rc = getattr(lib, "kart_sharded_fused_step" + sfx)(
            table.data_ptr(), table.shape[0], int(nb_local),
            part_ptrs.data_ptr() if parts else None, len(parts), k.data_ptr(),
            codes_t.data_ptr(), rlens.data_ptr(), L2.data_ptr(), int(primary), B, l_max, int(p),
            int(min_seed_len), int(max_seeds), ist.data_ptr(), tst.data_ptr(),
            state_out[0].data_ptr(), state_out[1].data_ptr(), out.data_ptr(), k_next.data_ptr(),
            _stream(dev))
    _raise_on(rc, "sharded_fused_step")
    _count(sharded_fused_step)


sharded_fused_step.launches = 0


def sharded_inv_psi(table, nb_local: int, L2, primary: int, seq_len: int, k, add=None):
    """csrc/sharded_fm.cu (G3): one step of the sampled-SA walk of the rows k
    (n,) on the card through the shard table (as sharded_occ4's): a row at a
    sample stays, others take an inverse-Psi step; zeros for the rows whose
    owner the table does not hold.  add (n,) int32, where given, gets one
    more step for every row not at a sample."""
    dev = k.device
    n = k.shape[0]
    idt, sfx = _check_table(table, L2, seq_len, dev)
    _check("k", k, idt, (n,), dev)
    if add is not None:
        _check("add", add, torch.int32, (n,), dev)
    out = torch.empty((n,), dtype=idt, device=dev)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        rc = getattr(lib, "kart_sharded_inv_psi" + sfx)(
            table.data_ptr(), table.shape[0], int(nb_local), L2.data_ptr(), int(primary),
            k.data_ptr(), n, out.data_ptr(), None if add is None else add.data_ptr(),
            _stream(dev))
    _raise_on(rc, "sharded_inv_psi")
    _count(sharded_inv_psi)
    return out


sharded_inv_psi.launches = 0


def sharded_gather(table, n_local: int, rows, shift: int = 0):
    """csrc/sharded_fm.cu (G4): one launch for every shard of the rows'
    device, through its shard table (as sharded_occ4's), rows (n,) of the
    index dtype: (n,) of that dtype, the full SA at rows (shift 0, the
    table's sa_full slabs of n_local = ns_local rows) or the sampled SA at
    rows >> 5 (shift 5, sa_samples, n_local = nsamp_local) where the table
    holds the row's owner, else 0."""
    dev = rows.device
    n = rows.shape[0]
    sfx = _index_sfx(rows)
    if shift not in (0, 5):
        raise ValueError(f"sharded_gather: shift {shift}, expected 0 (full SA) or 5 (samples)")
    if int(n_local) < 1:
        raise ValueError(f"sharded_gather: n_local {n_local}")
    _check("table", table, torch.int64, (table.shape[0], 4), dev, align=16)
    _check("rows", rows, rows.dtype, (n,), dev)
    out = torch.empty((n,), dtype=rows.dtype, device=dev)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        rc = getattr(lib, "kart_sharded_gather" + sfx)(
            table.data_ptr(), table.shape[0], int(n_local), rows.data_ptr(), n, int(shift),
            out.data_ptr(), _stream(dev))
    _raise_on(rc, "sharded_gather")
    _count(sharded_gather)
    return out


sharded_gather.launches = 0


# ---------------------------------------------------------------------------
# The PosDiff sort of the multi-device front half (csrc/sorted_occ.cu)
# ---------------------------------------------------------------------------

SORTED_OCC_MAX = 32  # slots a read: a lane a slot, a warp a read at most
SORTED_OCC_MIN_WORDS = 4096  # state words made at first: B up to some 262,000
_sorted_occ_state: dict = {}  # device -> the look-back's state words, zero between calls


def sorted_occ_state(dev, B: int) -> torch.Tensor:
    """The look-back state of csrc/sorted_occ.cu on dev, for B reads: int64
    words made zero once a device (or again, larger, for a larger B); each
    call leaves them zero.  One set a device, so calls on two streams of a
    device at once are not supported.  Raises where a larger set would have
    to be made inside a CUDA graph's capture: run one call outside it
    first."""
    need = _load().kart_sorted_occ_state_words(B)
    st = _sorted_occ_state.get(dev)
    if st is None or st.numel() < need:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"sorted_occurrences: {need} state words for B {B} on {dev} are to"
                               f" be made inside a CUDA graph's capture; call it once outside")
        st = torch.zeros((max(need, SORTED_OCC_MIN_WORDS),), dtype=torch.int64, device=dev)
        _sorted_occ_state[dev] = st
    return st


def sorted_occurrences(cnts, meta, gpos, B: int, s_occ: int):
    """csrc/sorted_occ.cu: the resolved stream (cnts (B,) int32, meta (H,)
    int32, gpos (H,) int32 or int64) on the card scattered to (B, s_occ)
    slots a read and sorted by (posdiff, rpos), as
    parallel/dp.py::sorted_occurrences_plain: (n_occ (B,) int32, rp, ln
    (B, s_occ) int32, gp (B, s_occ) of gpos's dtype, pd (B, s_occ) int32,
    present (B, s_occ) bool).  1 <= s_occ <= SORTED_OCC_MAX.  One launch,
    no memset: the look-back's state (`sorted_occ_state`) resets itself."""
    dev = meta.device
    H = meta.shape[0]
    if not 1 <= s_occ <= SORTED_OCC_MAX:
        raise ValueError(f"sorted_occurrences: s_occ {s_occ}, the kernel takes 1 to"
                         f" {SORTED_OCC_MAX}")
    if gpos.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gpos: expected int32 or int64 positions, got {gpos.dtype}")
    sfx = "" if gpos.dtype == torch.int32 else "_i64"
    _check("cnts", cnts, torch.int32, (B,), dev)
    _check("meta", meta, torch.int32, (H,), dev)
    _check("gpos", gpos, gpos.dtype, (H,), dev)
    i32 = torch.int32
    n_occ = torch.empty((B,), dtype=i32, device=dev)
    rp, ln, pd = (torch.empty((B, s_occ), dtype=i32, device=dev) for _ in range(3))
    gp = torch.empty((B, s_occ), dtype=gpos.dtype, device=dev)
    present = torch.empty((B, s_occ), dtype=torch.bool, device=dev)
    if B == 0:
        return n_occ, rp, ln, gp, pd, present
    state = sorted_occ_state(dev, B)
    lib = _load()
    with torch.cuda.device(dev):
        rc = getattr(lib, "kart_sorted_occurrences" + sfx)(
            cnts.data_ptr(), B, meta.data_ptr(), gpos.data_ptr(), H, s_occ, state.data_ptr(),
            n_occ.data_ptr(), rp.data_ptr(), ln.data_ptr(), gp.data_ptr(), pd.data_ptr(),
            present.data_ptr(), _stream(dev))
    _raise_on(rc, "sorted_occurrences")
    _count(sorted_occurrences)
    return n_occ, rp, ln, gp, pd, present


sorted_occurrences.launches = 0
