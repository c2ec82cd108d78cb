"""ctypes binding for the native post-seeding pipeline (kart_post.cpp).

The port's own copy of kart_tpu/native/post.py.  The library is built with
g++ from kart_tpu_torch/native/kart_post.cpp into kart_tpu_torch/_build/ at
first use; the C++ engine is the default backend and the post stage of the
device-pipelined path, so a failed build raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_NATIVE_DIR), "_build")
_LIB = None


def _compile_lib() -> str:
    src = os.path.join(_NATIVE_DIR, "kart_post.cpp")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.join(_BUILD_DIR, "libkartpost.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    tmp = os.path.join(_BUILD_DIR, "libkartpost.build.so")
    # plain -O3, the flags of kart_tpu's build
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", src, "-o", tmp, "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: cannot build {src}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load_postlib():
    """The C++ engine's library, built at first use.  Raises RuntimeError
    with g++'s output when the build fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(_compile_lib())
    i8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kart_ctx_create.restype = ctypes.c_void_p
    lib.kart_ctx_create.argtypes = [
        i8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_char_p, i64p, i64p, i64p, i64p, i64p, i64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.kart_ctx_destroy.argtypes = [ctypes.c_void_p]
    lib.kart_set_debug.restype = None
    lib.kart_set_debug.argtypes = [ctypes.c_int32]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.kart_ctx_set_seed_tables.restype = None
    lib.kart_ctx_set_seed_tables.argtypes = [
        ctypes.c_void_p, i32p, i32p, ctypes.c_int64, u32p, i64p, i32p, ctypes.c_int32,
    ]
    lib.kart_process_chunk.restype = ctypes.c_int64
    lib.kart_process_chunk.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i8p, i64p, i8p, i64p, ctypes.c_char_p, i64p,
        i32p, i32p, i32p, i64p, i64p,
        ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.kart_free.argtypes = [ctypes.c_char_p]
    lib.kart_ctx_set_sa_full.restype = None
    lib.kart_ctx_set_sa_full.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int64]
    lib.kart_ctx_set_fm_index.restype = None
    lib.kart_ctx_set_fm_index.argtypes = [
        ctypes.c_void_p, i64p, u32p, i64p, i64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.kart_process_chunk_packed.restype = ctypes.c_int64
    lib.kart_process_chunk_packed.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i8p, i64p, i8p, i64p, ctypes.c_char_p, i64p,
        i32p, ctypes.c_int32,
        i64p, ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.kart_nw_debug.restype = ctypes.c_int64
    lib.kart_nw_debug.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.kart_pack_reads_2bit.restype = ctypes.c_int64
    lib.kart_pack_reads_2bit.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int32, ctypes.c_int32,
        u32p, ctypes.c_int32, i32p, i32p, ctypes.c_int64,
    ]
    lib.kart_encode_reads.restype = None
    lib.kart_encode_reads.argtypes = [
        i8p, i64p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int8), i32p,
    ]
    lib.kart_reader_open.restype = ctypes.c_void_p
    lib.kart_reader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.kart_reader_next_chunk.restype = ctypes.c_int32
    lib.kart_reader_next_chunk.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.kart_reader_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeReader:
    """Native chunked FASTA/FASTQ reader with one-chunk prefetch (see
    kart_post.cpp NativeReader; semantics of reference src/GetData.cpp).
    Yields raw buffer pointers consumed zero-copy by
    NativePostProcessor.process_chunk_ptrs."""

    def __init__(self, path1: str, path2: str | None, fastq: bool,
                 pair_end: bool, pacbio: bool, n_bufs: int = 3):
        self.lib = load_postlib()
        self.h = self.lib.kart_reader_open(
            path1.encode(),
            path2.encode() if path2 else None,
            ctypes.c_int32(1 if fastq else 0),
            ctypes.c_int32(1 if pair_end else 0),
            ctypes.c_int32(1 if pacbio else 0),
            ctypes.c_int32(n_bufs),
        )
        if not self.h:
            raise RuntimeError(f"cannot open read file: {path1} / {path2}")

    def next_chunk(self):
        """-> (n_reads, (seq, seq_off, qual, qual_off, headers, header_off)
        raw ptrs); n_reads == 0 at end of input.  Pointers stay valid across
        n_bufs - 2 further next_chunk() calls (default depth-1 pipelining),
        then are reused."""
        seq = ctypes.c_void_p()
        seq_off = ctypes.c_void_p()
        qual = ctypes.c_void_p()
        qual_off = ctypes.c_void_p()
        headers = ctypes.c_void_p()
        header_off = ctypes.c_void_p()
        n = self.lib.kart_reader_next_chunk(
            self.h, ctypes.byref(seq), ctypes.byref(seq_off), ctypes.byref(qual),
            ctypes.byref(qual_off), ctypes.byref(headers), ctypes.byref(header_off),
        )
        return n, (seq, seq_off, qual, qual_off, headers, header_off)

    def close(self):
        if getattr(self, "h", None):
            self.lib.kart_reader_close(self.h)
            self.h = None

    def __del__(self):
        self.close()


class NativePostProcessor:
    """Owns a native context bound to one genome index + mapping options."""

    def __init__(self, gidx, pacbio, max_gaps, max_insert_size, min_seed_len,
                 multi_hit, n_threads=0, debug=False):
        self.lib = load_postlib()
        # process-wide, mirroring the reference's bDebugMode global
        self.lib.kart_set_debug(ctypes.c_int32(1 if debug else 0))
        if n_threads <= 0:
            # 2x oversubscription: with work-stealing blocks the extra
            # contexts fill reader-thread gaps and scheduler stalls
            # (measured best on 2-vCPU hosts); KART_THREADS overrides
            n_threads = int(
                os.environ.get("KART_THREADS", 2 * (os.cpu_count() or 1))
            )
        # keep referenced arrays alive for the context lifetime
        self._ref_seq = np.ascontiguousarray(gidx.ref_seq)
        names = [n.encode() for n in gidx.raw.chrom_names]
        self._names_concat = b"".join(names)
        off = np.zeros(len(names) + 1, dtype=np.int64)
        np.cumsum([len(n) for n in names], out=off[1:])
        self._name_off = off
        self._chrom_lens = np.ascontiguousarray(gidx.raw.chrom_lens, dtype=np.int64)
        self._fwd_loc = np.ascontiguousarray(gidx.chrom_fwd_loc, dtype=np.int64)
        self._rev_loc = np.ascontiguousarray(gidx.chrom_rev_loc, dtype=np.int64)
        keys, vals = gidx.chr_map
        self._keys = np.ascontiguousarray(keys, dtype=np.int64)
        self._vals = np.ascontiguousarray(vals, dtype=np.int64)
        self.ctx = self.lib.kart_ctx_create(
            _u8p(self._ref_seq),
            ctypes.c_int64(gidx.two_genome_size),
            ctypes.c_int64(gidx.genome_size),
            ctypes.c_int32(gidx.n_chrom),
            ctypes.c_char_p(self._names_concat),
            _i64p(self._name_off),
            _i64p(self._chrom_lens),
            _i64p(self._fwd_loc),
            _i64p(self._rev_loc),
            _i64p(self._keys),
            _i64p(self._vals),
            ctypes.c_int32(len(self._keys)),
            ctypes.c_int32(max_gaps),
            ctypes.c_int32(max_insert_size),
            ctypes.c_int32(min_seed_len),
            ctypes.c_int32(1 if pacbio else 0),
            ctypes.c_int32(1 if multi_hit else 0),
            ctypes.c_int32(n_threads),
        )

    def __del__(self):
        if getattr(self, "ctx", None) and self.lib is not None:
            self.lib.kart_ctx_destroy(self.ctx)
            self.ctx = None

    def set_seed_tables(self, tables) -> None:
        """Attach direct-lookup seeding tables (KmerSeedTables); after this,
        process_chunk may be called with seed_cnt=None for internal
        seeding."""
        self._tb_lo = np.ascontiguousarray(tables.table_lo_np, dtype=np.int32)
        self._tb_sa = np.ascontiguousarray(tables.sa_full_np, dtype=np.int32)
        bm_words = [np.ascontiguousarray(b, dtype=np.uint32) for b in tables.bitmaps_np]
        self._tb_bm = np.concatenate(bm_words)
        off = np.zeros(len(bm_words) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in bm_words], out=off[1:])
        self._tb_bm_off = off
        from ..ops.kmer_seed import BITMAP_KS

        self._tb_ks = np.array(BITMAP_KS, dtype=np.int32)
        self.lib.kart_ctx_set_seed_tables(
            self.ctx,
            _i32p(self._tb_lo),
            _i32p(self._tb_sa),
            ctypes.c_int64(tables.seq_len),
            self._tb_bm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            _i64p(self._tb_bm_off),
            _i32p(self._tb_ks),
            ctypes.c_int32(len(self._tb_ks)),
        )
        self.has_seed_tables = True

    def process_chunk_ptrs(self, n, pair_end, fastq, ptrs, stats):
        """Zero-copy chunk mapping from NativeReader buffers (internal
        direct-lookup seeding; requires set_seed_tables).  Returns SAM text."""
        seq, seq_off, qual, qual_off, headers, header_off = ptrs
        i8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        null_i32 = ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
        null_i64 = ctypes.cast(None, i64p)
        st = np.array(
            [stats["paired"], stats["distance"], stats["unique"], stats["unmapped"]],
            dtype=np.int64,
        )
        out = ctypes.c_char_p()
        size = self.lib.kart_process_chunk(
            self.ctx,
            ctypes.c_int32(n),
            ctypes.c_int32(1 if pair_end else 0),
            ctypes.c_int32(1 if fastq else 0),
            ctypes.cast(seq, i8p),
            ctypes.cast(seq_off, i64p),
            ctypes.cast(qual, i8p),
            ctypes.cast(qual_off, i64p) if qual.value else null_i64,
            ctypes.cast(headers, ctypes.c_char_p),
            ctypes.cast(header_off, i64p),
            null_i32, null_i32, null_i32, null_i64,
            _i64p(st),
            ctypes.byref(out),
        )
        sam = ctypes.string_at(out, size)  # bytes; buffer is ctx-owned
        stats["paired"] = int(st[0])
        stats["distance"] = int(st[1])
        stats["unique"] = int(st[2])
        stats["unmapped"] = int(st[3])
        return sam

    def set_fm_index(self, gidx) -> None:
        """Attach the FM index (.bwt/.sa arrays) as the native seeding
        engine — the reference's memory-frugal scheme (backward search +
        inverse-Psi sampled-SA walks, src/bwt_search.cpp / bwt.c:101-123).
        Used when the 13-mer direct tables are unavailable (human-scale
        genomes, KART_SA_MODE=sampled): no .saf, no full SA anywhere."""
        r = gidx.raw
        self._fm_occ = np.ascontiguousarray(r.occ_cp, dtype=np.int64).reshape(-1)
        self._fm_words = np.ascontiguousarray(r.bwt_words, dtype=np.uint32).reshape(-1)
        self._fm_sa = np.ascontiguousarray(r.sa_samples, dtype=np.int64)
        self._fm_L2 = np.ascontiguousarray(r.L2, dtype=np.int64)
        self.lib.kart_ctx_set_fm_index(
            self.ctx,
            _i64p(self._fm_occ),
            self._fm_words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            _i64p(self._fm_sa),
            _i64p(self._fm_L2),
            ctypes.c_int64(r.primary),
            ctypes.c_int64(r.seq_len),
            ctypes.c_int32(r.sa_intv),
        )
        self.has_fm_index = True

    def set_sa_full(self, sa_full_np, seq_len) -> None:
        """Attach the full SA for packed-seed occurrence expansion when the
        direct-lookup tables are not in use."""
        self._sa_only = np.ascontiguousarray(sa_full_np, dtype=np.int32)
        self.lib.kart_ctx_set_sa_full(
            self.ctx, _i32p(self._sa_only), ctypes.c_int64(seq_len)
        )
        self.has_sa_full = True

    def encode_reads_ptrs(self, n, ptrs, rows, l_max):
        """Encode a NativeReader chunk into the device kernels' (rows,
        l_max) int8 layout (codes, padded 4).  Returns (reads, rlens)."""
        reads = np.full((rows, l_max), 4, dtype=np.int8)
        rlens = np.zeros(rows, dtype=np.int32)
        self.encode_reads_into(n, ptrs, reads, rlens, 0, l_max)
        return reads, rlens

    def encode_reads_into(self, n, ptrs, reads, rlens, row, l_max):
        """Encode a NativeReader chunk into rows [row, row+n) of a
        C-contiguous (B, l_max) int8 batch (group fusion: several chunks
        share one device dispatch)."""
        seq, seq_off, _, _, _, _ = ptrs
        sub = reads[row:]
        self.lib.kart_encode_reads(
            ctypes.cast(seq, ctypes.POINTER(ctypes.c_uint8)),
            ctypes.cast(seq_off, ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int32(n),
            ctypes.c_int32(l_max),
            sub.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            rlens[row:].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )

    def process_chunk_flat(self, n, pair_end, fastq, ptrs, cnt, rpos, slen, gpos, stats):
        """Chunk mapping from NativeReader buffers with DEVICE-RESOLVED flat
        seeds (per-read counts + per-occurrence rpos/len/text-position, the
        ops/resolve.py layout).  No SA access happens natively — the device
        already resolved every occurrence.  Returns SAM text."""
        seq, seq_off, qual, qual_off, headers, header_off = ptrs
        i8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        cnt = np.ascontiguousarray(cnt, dtype=np.int32)
        rpos = np.ascontiguousarray(rpos, dtype=np.int32)
        slen = np.ascontiguousarray(slen, dtype=np.int32)
        gpos = np.ascontiguousarray(gpos, dtype=np.int64)
        st = np.array(
            [stats["paired"], stats["distance"], stats["unique"], stats["unmapped"]],
            dtype=np.int64,
        )
        out = ctypes.c_char_p()
        size = self.lib.kart_process_chunk(
            self.ctx,
            ctypes.c_int32(n),
            ctypes.c_int32(1 if pair_end else 0),
            ctypes.c_int32(1 if fastq else 0),
            ctypes.cast(seq, i8p),
            ctypes.cast(seq_off, i64p),
            ctypes.cast(qual, i8p),
            ctypes.cast(qual_off, i64p) if qual.value else ctypes.cast(None, i64p),
            ctypes.cast(headers, ctypes.c_char_p),
            ctypes.cast(header_off, i64p),
            _i32p(cnt),
            _i32p(rpos),
            _i32p(slen),
            _i64p(gpos),
            _i64p(st),
            ctypes.byref(out),
        )
        sam = ctypes.string_at(out, size)  # bytes; buffer is ctx-owned
        stats["paired"] = int(st[0])
        stats["distance"] = int(st[1])
        stats["unique"] = int(st[2])
        stats["unmapped"] = int(st[3])
        return sam

    def process_chunk_packed(self, n, pair_end, fastq, ptrs, packed, max_seeds, stats):
        """Chunk mapping from NativeReader buffers with DEVICE-produced
        packed seeds (seed_scan layout, (>=n, 1+4*max_seeds) int32);
        occurrence expansion happens natively.  Returns SAM text."""
        seq, seq_off, qual, qual_off, headers, header_off = ptrs
        i8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        packed = np.ascontiguousarray(packed, dtype=np.int32)
        st = np.array(
            [stats["paired"], stats["distance"], stats["unique"], stats["unmapped"]],
            dtype=np.int64,
        )
        out = ctypes.c_char_p()
        size = self.lib.kart_process_chunk_packed(
            self.ctx,
            ctypes.c_int32(n),
            ctypes.c_int32(1 if pair_end else 0),
            ctypes.c_int32(1 if fastq else 0),
            ctypes.cast(seq, i8p),
            ctypes.cast(seq_off, i64p),
            ctypes.cast(qual, i8p),
            ctypes.cast(qual_off, i64p) if qual.value else ctypes.cast(None, i64p),
            ctypes.cast(headers, ctypes.c_char_p),
            ctypes.cast(header_off, i64p),
            _i32p(packed),
            ctypes.c_int32(max_seeds),
            _i64p(st),
            ctypes.byref(out),
        )
        sam = ctypes.string_at(out, size)  # bytes; buffer is ctx-owned
        stats["paired"] = int(st[0])
        stats["distance"] = int(st[1])
        stats["unique"] = int(st[2])
        stats["unmapped"] = int(st[3])
        return sam

    def process_chunk(self, chunk, pair_end, fastq, seed_cnt, seed_rpos, seed_len,
                      seed_gpos, stats):
        """chunk: list[RawRead]; seed arrays flat per read (counts in
        seed_cnt), or seed_cnt=None to seed natively via the attached
        direct-lookup tables; stats dict mutated in place; returns SAM
        text str."""
        n = len(chunk)
        seq_concat = b"".join(r.seq for r in chunk)
        seq_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([r.rlen for r in chunk], out=seq_off[1:])
        if fastq and chunk[0].qual is not None:
            qual_concat = b"".join(r.qual for r in chunk)
            qual_arr = np.frombuffer(qual_concat, dtype=np.uint8)
            qual_ptr = _u8p(qual_arr)
            qual_off = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(r.qual) for r in chunk], out=qual_off[1:])
            qual_off_ptr = _i64p(qual_off)
        else:
            qual_arr = None
            qual_ptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
            qual_off_ptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_int64))
        headers = [r.header.encode() for r in chunk]
        header_concat = b"".join(headers)
        header_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(h) for h in headers], out=header_off[1:])

        seq_arr = np.frombuffer(seq_concat, dtype=np.uint8)
        if seed_cnt is None:
            null_i32 = ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
            null_i64 = ctypes.cast(None, ctypes.POINTER(ctypes.c_int64))
            cnt_ptr, rp_ptr, ln_ptr, gp_ptr = null_i32, null_i32, null_i32, null_i64
        else:
            seed_cnt = np.ascontiguousarray(seed_cnt, dtype=np.int32)
            seed_rpos = np.ascontiguousarray(seed_rpos, dtype=np.int32)
            seed_len = np.ascontiguousarray(seed_len, dtype=np.int32)
            seed_gpos = np.ascontiguousarray(seed_gpos, dtype=np.int64)
            cnt_ptr, rp_ptr, ln_ptr = _i32p(seed_cnt), _i32p(seed_rpos), _i32p(seed_len)
            gp_ptr = _i64p(seed_gpos)

        st = np.array(
            [stats["paired"], stats["distance"], stats["unique"], stats["unmapped"]],
            dtype=np.int64,
        )
        out = ctypes.c_char_p()
        size = self.lib.kart_process_chunk(
            self.ctx,
            ctypes.c_int32(n),
            ctypes.c_int32(1 if pair_end else 0),
            ctypes.c_int32(1 if fastq else 0),
            _u8p(seq_arr),
            _i64p(seq_off),
            qual_ptr,
            qual_off_ptr,
            ctypes.c_char_p(header_concat),
            _i64p(header_off),
            cnt_ptr,
            rp_ptr,
            ln_ptr,
            gp_ptr,
            _i64p(st),
            ctypes.byref(out),
        )
        sam = ctypes.string_at(out, size)  # bytes; buffer is ctx-owned
        stats["paired"] = int(st[0])
        stats["distance"] = int(st[1])
        stats["unique"] = int(st[2])
        stats["unmapped"] = int(st[3])
        return sam
