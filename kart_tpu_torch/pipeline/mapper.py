"""Chunk mapper of the port.

Counterpart of kart_tpu's KartMapper (`kart_tpu/pipeline/mapper.py`) for
Illumina reads and, with `pacbio`, PacBio reads, in three modes:

* native (the default backend): the host C++ engine (native/post.py) seeds and maps
  every chunk (`NativeReader` + `process_chunk_ptrs`); no device is used.
* device-pipelined (`KART_SEED_MODE=device`, native backend): groups of G
  reader chunks are encoded and 2-bit packed on the host, seeded on the
  device by the 13-mer funnel (or by the FM stepper when the tables fail
  kart_tpu's gate), expanded and resolved through the full SA (or, in the
  sampled SA mode, by inverse-Psi walks over the sampled SA) and packed
  into one int32 stream there, downloaded, and mapped by the C++ engine
  (`process_chunk_flat`).  Lanes that the funnel or the occurrence budget
  flag are re-seeded exactly by the FM stepper.  PacBio reads take the
  SensitiveMode forms of both (30-base windows), in groups of 64 chunks of
  10 reads and the plain 32-bit stream.  On a CUDA device each
  group is one stream of pinned uploads, kernels and a pinned download,
  ended by an event, so group k seeds while group k-1 is mapped on the
  host; with `-cpu` the plain versions run in line.  A device or kernel
  error raises: there is no fall-back to the host engine.
* python backend (`-backend python`): device seeding (the 13-mer funnel,
  `ops/kmer_seed.kmer_seed_scan`, where the tables pass the gate, its
  flagged lanes re-seeded by `ops/fm_search.seed_scan`; else `seed_scan`
  alone, or `sensitive_scan` for PacBio), occurrences resolved by a full-SA
  gather or a device `sa_walk`, host divide and report, every NW fragment
  of a chunk as one device batch (`ops/nw.nw_align_batch`).  With
  KART_DEVICE_CLUSTER=1 the Illumina candidates are clustered on the device
  (`ops/cluster`), and with KART_DEVICE_PAIR=1 the paired-end candidates
  are mated there (`ops/pairing`), both read at every chunk as kart_tpu
  reads them; the other modes read neither switch.

The sharded index (`idx_shards` N > 1, the CLI's -idx-shards): FastMode
seeding and SA resolution go through the FM index split into N slabs
(parallel/sharded_index.py), slab s on `shard_devices[s]`, in the native
backend (the python reader, four chunks seeded at a time, the C++ engine
mapping each chunk) and in the python backend; lanes over the occurrence
budget are re-seeded on the host.  As in kart_tpu, the funnel's tables are
not used then, and the device-pipelined mode and PacBio seeding keep the
replicated index.

The SA mode (KART_SA_MODE, as kart_tpu reads it): "full" resolves
occurrences through the full suffix array, "sampled" through the intv-32
sampled SA that Kart itself walks (bwt.c:101-123), and never builds the
full SA nor the funnel's tables (which are made from it); "auto" (the
default) is full where the index has its .saf sidecar or fewer than 2**31
text bases.  An index of 2**31 text bases or more is int64 throughout.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import os

import numpy as np
import torch

from ..index.format import NT4_TABLE
from ..index.loader import GenomeIndex
from ..io.fastq import RawRead, ReadStream, next_chunk
from ..ops.cluster import cluster_batch_to_candidates
from ..ops.fm_search import FMIndexTensors, sa_walk, seed_scan, sensitive_scan, unpack_seed_scan
from ..ops.int32 import check_int32_index
from ..ops.kmer_seed import (
    KmerTablesTensors,
    build_tables,
    hit_cap_for,
    kmer_seed_scan,
    unpack_seed_result,
)
from ..ops.nw import nw_align_batch
from ..ops.pack import (
    kmer_seed_scan_resolved_packed,
    pack_reads_2bit,
    seed_scan_resolved_packed,
    sensitive_scan_resolved_packed,
    unpack_stream,
)
from ..ops.pairing import pair_chunk_on_device
from ..ops.resolve import decode_resolved_counts
from ..parallel.sharded_index import (
    ShardedFM,
    build_sharded_fm,
    default_shard_devices,
    sharded_seed_scan_resolved,
)
from ..utils.trace import count, setup_span, span
from .candidates import (
    Seed,
    gen_candidates_illumina,
    gen_candidates_pacbio,
    remove_redundant_candidates,
)
from .conquer import Conquer
from .pairing import (
    check_paired_candidates,
    check_paired_final_alignments,
    remove_unmated_candidates,
    rescue_unpaired,
)
from .report import ReadState, gen_mapping_report
from .sam import (
    evaluate_mapq,
    output_paired,
    output_single,
    set_paired_flags,
    set_single_flag,
)

# kart_tpu's buckets.  l_max sets max_seeds, hence which seeds are dropped,
# so the port pads to the same l_max everywhere.  In the device-pipelined
# mode the batch is padded to the B buckets too: the funnel's slabs and the
# occurrence budget depend on B, and with them which lanes are flagged.
# The python backend does not pad the batch: its rows are independent, and
# the lanes its funnel flags (which depend on the slabs) are re-seeded exactly.
_B_BUCKETS = [2048, 16000]
_L_BUCKETS = [64, 128, 160, 256, 384, 512]
_CHUNK = 4000  # reads per reader chunk (kart_tpu's native reader)
_PB_B_BUCKETS = [16]
_PB_L_BUCKETS = [512, 1024, 2048, 4096, 8192, 16384, 32768]
_PB_CHUNK = 10  # PacBio reads per reader chunk


def compute_min_seed_length(two_genome_size: int) -> int:
    """Mapping.cpp:645: smallest k in 13..15 with 4^k > 2L, else 16."""
    for m in range(13, 16):
        if two_genome_size < 4**m:
            return m
    return 16


def _bucket(x: int, buckets: list[int]) -> int:
    for b in buckets:
        if x <= b:
            return b
    return x


def _host_arrays(stream):
    """A downloaded or CPU stream as numpy: one int32 array, or an int64
    index's (cnts, meta, gpos) tuple."""
    if isinstance(stream, tuple):
        return tuple(t.cpu().numpy() for t in stream)
    return stream.cpu().numpy()


def _no_seeds(n: int):
    """The flat seed arrays of n reads without a seed."""
    return (np.zeros(n, np.int32), np.zeros(0, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.int64))


class TorchKartMapper:
    """Illumina single- and paired-end mapping, and PacBio mapping, on one
    torch device.

    `device` "cuda" runs the CUDA kernels; "cpu" runs their plain versions.
    `backend` "native" maps with the C++ engine (seeding on the host,
    or on the device with KART_SEED_MODE=device); "python" runs the python
    pipeline around device seeding and device NW.  `idx_shards` N > 1 seeds
    through the index split over `shard_devices` (N torch devices; by
    default default_shard_devices(N, device): one a card, contiguous runs of
    shards on each card where there are more shards than cards, or N times
    the CPU)."""

    def __init__(
        self,
        gidx: GenomeIndex,
        *,
        device,
        pacbio: bool = False,
        max_gaps: int = 5,
        max_insert_size: int = 1500,
        multi_hit: bool = False,
        backend: str = "native",
        n_threads: int = 0,
        debug: bool = False,
        idx_shards: int = 0,
        shard_devices=None,
    ):
        if backend not in ("native", "python"):
            raise ValueError(f"unknown backend {backend!r}")
        self.device = torch.device(device)
        self.gidx = gidx
        self.backend = backend
        self.pacbio = pacbio
        self.max_gaps = max_gaps
        self.max_insert_size = max_insert_size
        self.multi_hit = multi_hit
        self.min_seed_len = compute_min_seed_length(gidx.two_genome_size)
        self.conquer = Conquer(gidx.ref_seq, pacbio, max_gaps)
        sa_mode = os.environ.get("KART_SA_MODE", "auto")
        if sa_mode == "auto":
            has_saf = bool(gidx.raw.prefix) and os.path.exists(gidx.raw.prefix + ".saf")
            sa_mode = "full" if (has_saf or gidx.seq_len < 2**31) else "sampled"
        if sa_mode not in ("full", "sampled"):
            raise ValueError(f"KART_SA_MODE={sa_mode!r}: expected auto, full or sampled")
        self.sa_mode = sa_mode
        # device arrays are made at first use: the native mode never needs them
        self._fm = None
        self._tables = None
        self._tables_tried = False
        self._tables_dev = None
        self._sa_dev = None
        self._stream = None
        # the sharded index (0 or 1: the replicated one), made at first use
        self.idx_shards = int(idx_shards or 0)
        self.shard_devices = shard_devices
        self._sharded = None
        self.native = None
        if backend == "native":
            from ..native.post import NativePostProcessor

            self.native = NativePostProcessor(
                gidx, pacbio, max_gaps, max_insert_size, self.min_seed_len, multi_hit,
                n_threads=n_threads, debug=debug,
            )
        # shared counters (reference: Mapping.cpp:20)
        self.stats = dict(total=0, unique=0, unmapped=0, paired=0, distance=0)
        # device-pipelined mode, one entry per dispatch group: reads, lanes
        # flagged by the funnel or the budget, and how they were re-seeded
        self.group_log: list[dict] = []

    @property
    def sa_full_np(self):
        """The host's full SA in the full SA mode (built or loaded at first
        use), None in the sampled mode."""
        return self.gidx.sa_full if self.sa_mode == "full" else None

    @property
    def fm(self) -> FMIndexTensors:
        if self._fm is None:
            with self._uploading():
                self._fm = FMIndexTensors.from_genome_index(
                    self.gidx, self.device, with_full_sa=None if self.sa_mode == "full" else False)
        return self._fm

    @contextlib.contextmanager
    def _uploading(self):
        """The block's device copies of index arrays inside the
        `kart.index.upload` set-up span (on a card, until they are done);
        then the `index_device_bytes` counter is set anew."""
        with setup_span("kart.index.upload"):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        count("index_device_bytes", self.index_device_bytes())

    def index_device_bytes(self) -> int:
        """Bytes of the index tensors this mapper holds on its device: the FM
        index, the funnel's tables and the full SA, each storage once where
        two names share it.  On a card the FM index's copy of the full SA
        stays on the host, and is not counted."""
        tensors = [self._sa_dev] + [v for h in (self._fm, self._tables_dev) if h is not None
                                    for v in vars(h).values()]
        seen = {}
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.device.type == self.device.type:
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values())

    def _get_kmer_tables(self):
        """kart_tpu's gate for the 13-mer funnel: genome at most
        KART_KMER_GATE bases, every 4-mer present (exact sub-13 restarts),
        13-mer multiplicity at most 4096.  None when the gate refuses, in
        the sampled SA mode (the tables are built around the full SA), and
        with the sharded index (the tables would be as oversized as the
        index, and would bypass the sharded scan)."""
        if self._tables_tried:
            return self._tables
        self._tables_tried = True
        if self.sa_mode != "full" or self.idx_shards > 1:
            return None
        gate = int(os.environ.get("KART_KMER_GATE", "1200000000"))
        if self.gidx.seq_len > gate:
            return None
        tb = build_tables(self.gidx)
        if tb.all_short_present and tb.max_mult <= 4096:
            self._tables = tb
        return self._tables

    def _get_sharded(self) -> ShardedFM:
        """The index split over the shard devices, made at first use."""
        if self._sharded is None:
            devices = self.shard_devices
            if devices is None:
                devices = default_shard_devices(self.idx_shards, self.device)
            if len(devices) != self.idx_shards:
                raise ValueError(f"idx_shards={self.idx_shards} but {len(devices)} shard devices")
            self._sharded = build_sharded_fm(self.gidx, devices, sa_mode=self.sa_mode)
        return self._sharded

    def _device_tables(self) -> KmerTablesTensors:
        if self._tables_dev is None:
            tb = self._get_kmer_tables()
            with self._uploading():
                self._tables_dev = KmerTablesTensors.from_tables(tb, self.device)
        return self._tables_dev

    def _device_sa_mode(self) -> str:
        """The device resolver, chosen from what the device index holds (as
        kart_tpu's): "full" where it carries the full SA, else "sampled"."""
        return "full" if self.fm.sa_full is not None else "sampled"

    def _device_sa(self) -> torch.Tensor | None:
        """The full SA on the device in the index dtype (the funnel tables'
        copy when they exist and the index is int32); None in the sampled
        device mode."""
        if self._sa_dev is None and self._device_sa_mode() == "full":
            if self._get_kmer_tables() is not None and self.fm.index_dtype == torch.int32:
                self._sa_dev = self._device_tables().sa_full
            else:
                sa = self.fm.sa_full
                with self._uploading():
                    self._sa_dev = sa.to(self.device)
        return self._sa_dev

    # ------------------------------------------------------------------
    # Seeding
    # ------------------------------------------------------------------

    def _encode(self, seq: bytes) -> np.ndarray:
        return NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)].astype(np.int32)

    def _seed_batch_flat(self, enc_reads: list[np.ndarray]):
        """FastMode seeding for a batch of encoded reads -> flat arrays
        (per-read counts, rpos, length, gpos) in emission x occurrence
        order (the order IdentifySeedPairs_FastMode pushes seeds, before
        its PosDiff sort).  The funnel seeds where the tables pass the gate,
        and the FM stepper re-seeds the lanes it flags; else the FM stepper
        seeds every read."""
        n = len(enc_reads)
        if n == 0:
            return _no_seeds(0)
        rlens = np.array([len(e) for e in enc_reads], dtype=np.int32)
        l_max = _bucket(int(rlens.max()), _L_BUCKETS)
        reads = np.full((n, l_max), 4, dtype=np.int32)
        for i, e in enumerate(enc_reads):
            reads[i, : len(e)] = e[:l_max]
        max_seeds = self._max_seeds(l_max)
        if self.idx_shards > 1:
            # expanded and resolved by the sharded index (the host's full SA
            # is never read); a read over the budget is re-seeded on the host
            cnts, meta, gpos = self._sharded_seed_resolved(reads, rlens, max_seeds, l_max)
            ok, tot, offs = decode_resolved_counts(cnts)
            bad = np.nonzero(~ok)[0]
            self.group_log.append(dict(reads=n, flagged=len(bad), reseeded_device=0,
                                       reseeded_host=len(bad)))
            overrides = {int(i): self._reseed_host_flat(enc_reads[i]) for i in bad}
            res = (tot, offs, (meta & 0xFFFF).astype(np.int32),
                   ((meta >> 16) & 0xFFFF).astype(np.int32), gpos, overrides)
            return self._chunk_flat(res, 0, n)

        def fm_seeds(rows):
            packed = seed_scan(
                self.fm,
                torch.from_numpy(reads[rows]).to(self.device),
                torch.from_numpy(rlens[rows]).to(self.device),
                self.min_seed_len,
                max_seeds=max_seeds,
                l_max=l_max,
            ).cpu().numpy()
            return unpack_seed_scan(packed, max_seeds)

        tb = self._get_kmer_tables()
        if tb is None:
            return self._flatten_seeds(fm_seeds(slice(None)), max_seeds)
        # kart_tpu pads the batch to its B buckets, which changes the funnel's
        # slabs and so which lanes it flags; a flagged lane is re-seeded
        # exactly, so the seeds are the same either way, and the port does
        # not pad
        out = unpack_seed_result(kmer_seed_scan(
            self._device_tables(),
            torch.from_numpy(reads).to(self.device),
            torch.from_numpy(rlens).to(self.device),
            self.min_seed_len,
            max_seeds=max_seeds,
            l_max=l_max,
            hit_cap=hit_cap_for(tb.max_mult),
            rounds=l_max // 10 + 4,
        ).cpu().numpy(), max_seeds)
        fields = {k: out[k] for k in ("n_seeds", "rpos", "slen", "freq")}
        fields["k0"] = out["k0"].astype(np.int64)  # an int64 index's re-seeds carry int64 rows
        bad = np.nonzero(~out["ok"])[0]
        if len(bad):
            again = fm_seeds(bad)
            for k, a in fields.items():
                a[bad] = again[k]
        return self._flatten_seeds(fields, max_seeds)

    def _sharded_seed_resolved(self, reads: np.ndarray, rlens: np.ndarray, max_seeds: int,
                               l_max: int):
        """FastMode seeding of (B, l_max) reads against the sharded index,
        the occurrences expanded and resolved there: the host (cnts, meta,
        gpos) stream.  The budget is taken from the real reads (kart_tpu pads
        the batch first, so it may flag other lanes, not other seeds)."""
        stream = sharded_seed_scan_resolved(
            self._get_sharded(), torch.from_numpy(reads), torch.from_numpy(rlens),
            self.min_seed_len, max_seeds=max_seeds, l_max=l_max,
            occ_budget=self._occ_budget(reads.shape[0], l_max))
        return tuple(t.cpu().numpy() for t in stream)

    def _seed_sensitive_batch_flat(self, enc_reads: list[np.ndarray]):
        """SensitiveMode seeding for a batch of encoded reads on the device
        -> the flat arrays of _seed_batch_flat (the order
        IdentifySeedPairs_SensitiveMode pushes seeds, before its gPos
        sort).  The batch is padded to kart_tpu's 16 lanes."""
        n = len(enc_reads)
        if n == 0:
            return _no_seeds(0)
        rlens = np.array([len(e) for e in enc_reads], dtype=np.int32)
        l_max = _bucket(int(rlens.max()), _PB_L_BUCKETS)
        B = _bucket(n, _PB_B_BUCKETS)
        reads = np.full((B, l_max), 4, dtype=np.int32)
        for i, e in enumerate(enc_reads):
            reads[i, : len(e)] = e[:l_max]
        rl = np.zeros(B, dtype=np.int32)
        rl[:n] = np.minimum(rlens, l_max)
        max_seeds = self._max_seeds(l_max)
        packed = sensitive_scan(
            self.fm,
            torch.from_numpy(reads).to(self.device),
            torch.from_numpy(rl).to(self.device),
            self.min_seed_len,
            max_seeds=max_seeds,
            l_max=l_max,
        ).cpu().numpy()[:n]
        return self._flatten_seeds(unpack_seed_scan(packed, max_seeds), max_seeds)

    def _resolve_rows(self, rows: np.ndarray) -> np.ndarray:
        """SA rows -> text positions (int64): one full-SA gather in the full
        SA mode; in the sampled mode one sa_walk of the rows on the device,
        and the rows whose walk max_steps cut finished on the host
        (fm_ref.sa_lookup), as kart_tpu's _resolve_rows."""
        if self.sa_mode == "full":
            return self.sa_full_np[rows].astype(np.int64)
        idt = np.int64 if self.fm.index_dtype == torch.int64 else np.int32
        pos, done = sa_walk(self.fm, torch.from_numpy(rows.astype(idt)).to(self.device))
        pos = pos.cpu().numpy().astype(np.int64)
        for i in np.nonzero(~done.cpu().numpy())[0]:
            pos[i] = self._host_fm().sa_lookup(int(rows[i]))
        return pos

    def _flatten_seeds(self, out: dict, max_seeds: int):
        """The seed fields of n reads (n_seeds (n,), and rpos, slen, k0, freq
        (n, max_seeds)) -> flat per-occurrence arrays (counts (n,), rpos,
        length, gpos), resolved by _resolve_rows."""
        n_seeds, rpos, slen = out["n_seeds"], out["rpos"], out["slen"]
        k0, freq = out["k0"], out["freq"]
        sidx = np.arange(max_seeds)[None, :] < n_seeds[:, None]
        f = np.where(sidx, freq, 0)
        reps = f.reshape(-1)
        total = int(reps.sum())
        if total == 0:
            return _no_seeds(len(n_seeds))
        base = np.repeat(k0.reshape(-1).astype(np.int64), reps)
        cum = np.cumsum(reps)
        offs = np.arange(total) - np.repeat(cum - reps, reps)
        locs = self._resolve_rows(base + offs)
        rp_flat = np.repeat(rpos.reshape(-1), reps).astype(np.int32)
        ln_flat = np.repeat(slen.reshape(-1), reps).astype(np.int32)
        cnts = f.sum(axis=1).astype(np.int32)
        return cnts, rp_flat, ln_flat, locs

    def _seed_sensitive_flat(self, enc: np.ndarray):
        """SensitiveMode seeding of one read on the host
        (IdentifySeedPairs_SensitiveMode, AlignmentCandidates.cpp:132-169):
        emission-order (rpos, len, gpos) tuples, before the gPos sort."""
        rlen = len(enc)
        out: list[tuple[int, int, int]] = []
        pos, stop_pos, end_pos = 0, 30, rlen - self.min_seed_len
        while pos < end_pos:
            if enc[pos] > 3:
                pos += 1
                stop_pos += 1
            else:
                length, freq, locs = self._host_fm().search(enc, pos, stop_pos, self.min_seed_len)
                if freq > 0:
                    for loc in locs:
                        out.append((pos, length, int(loc)))
                    pos += length
                    stop_pos += length
                else:
                    pos += self.min_seed_len
                    stop_pos += self.min_seed_len
                if stop_pos > rlen:
                    stop_pos = rlen
        return out

    def _seeds_to_lists(self, n, flat, key=None) -> list[list[Seed]]:
        """Flat seed arrays -> per-read Seed lists sorted by (PosDiff, rpos),
        or by `key` (PacBio: (gpos, rpos), CompByGenomePos)."""
        cnts, rp, ln, gp = flat
        if key is None:
            def key(s):
                return (s.posdiff, s.rpos)
        result: list[list[Seed]] = []
        base = 0
        for i in range(n):
            seeds = [
                Seed(True, int(rp[base + t]), int(gp[base + t]), int(ln[base + t]),
                     int(ln[base + t]), int(gp[base + t]) - int(rp[base + t]))
                for t in range(int(cnts[i]))
            ]
            seeds.sort(key=key)
            result.append(seeds)
            base += int(cnts[i])
        return result

    # ------------------------------------------------------------------
    # Chunk mapping
    # ------------------------------------------------------------------

    def _est_distance(self) -> int:
        # Mapping.cpp:533-540
        if self.stats["paired"] >= 1000:
            est = self.stats["distance"] // (self.stats["paired"] >> 2)
            return est + (est >> 1)
        return self.max_insert_size

    def _make_state(self, r: RawRead) -> ReadState:
        return ReadState(header=r.header, seq=r.seq, qual=r.qual, rlen=r.rlen)

    def _batch_nw(self, report_jobs) -> None:
        """Batched device conquer: dry-run the report pass on deep copies to
        collect every NW fragment pair the chunk will need (NW inputs are
        NW-independent: repartition precedes the DP, decisions follow it),
        run them as ONE device NW batch, and prime the conquer memo that the
        real pass reads (a miss there is counted in nw_memo_misses)."""
        keys: set = set()
        self.conquer.collecting = keys
        try:
            for first_read, st, cands in report_jobs:
                st_copy = ReadState(header=st.header, seq=st.seq, qual=st.qual, rlen=st.rlen)
                gen_mapping_report(
                    self.gidx, self.conquer, first_read, st_copy,
                    copy.deepcopy(cands), self.pacbio, self.multi_hit,
                )
        finally:
            self.conquer.collecting = None
        pairs = sorted(keys)  # deterministic batch order
        self.conquer.nw_memo = dict(zip(pairs, nw_align_batch(pairs, device=self.device)))

    def map_chunk(self, chunk: list[RawRead], pair_end: bool, fastq: bool) -> list[str]:
        """The SAM lines of one reader chunk: the C++ engine (native
        backend) or the python pipeline."""
        if not chunk:
            return []
        if self.native is not None:
            return self._map_chunk_native(chunk, pair_end, fastq)
        return self._map_chunk_python(chunk, pair_end, fastq)

    def _map_chunk_native(self, chunk: list[RawRead], pair_end: bool, fastq: bool) -> list[str]:
        """One chunk through the C++ engine: seeded there where it has its
        seeding index, else seeded here (the sharded index; PacBio through
        the SensitiveMode stepper on the replicated index) and mapped
        there."""
        n = len(chunk)
        if self._native_seeding_ready():
            flat = (None,) * 4
        elif self.pacbio:
            flat = self._seed_sensitive_batch_flat([self._encode(r.seq) for r in chunk])
        else:
            flat = self._seed_batch_flat([self._encode(r.seq) for r in chunk])
        use_pairs = pair_end and n % 2 == 0 and not self.pacbio
        sam_text = self.native.process_chunk(chunk, use_pairs, fastq, *flat, self.stats)
        self.stats["total"] += n
        return sam_text.decode("ascii").splitlines()

    def _map_chunk_python(self, chunk: list[RawRead], pair_end: bool, fastq: bool) -> list[str]:
        n = len(chunk)
        sam: list[str] = []
        my = dict(unique=0, unmapped=0, paired=0, distance=0)
        states = [self._make_state(r) for r in chunk]
        if self.pacbio:
            flat = self._seed_sensitive_batch_flat([self._encode(r.seq) for r in chunk])
            seeds_all = self._seeds_to_lists(n, flat, key=lambda s: (s.gpos, s.rpos))
            cands_all = []
            for r, seeds in zip(chunk, seeds_all):
                cands = gen_candidates_pacbio(r.rlen, seeds)
                remove_redundant_candidates(cands, pacbio=True)
                cands_all.append(cands)
            self._batch_nw([(True, states[i], cands_all[i]) for i in range(n)])
            for st, cands in zip(states, cands_all):
                gen_mapping_report(self.gidx, self.conquer, True, st, cands, True, self.multi_hit)
                set_single_flag(st)
                evaluate_mapq(st, pacbio=True)
            self.conquer.nw_memo = None
            for st in states:
                sam.extend(output_single(self.gidx, st, fastq, self.multi_hit, my))
            self.stats["total"] += n
            for k in ("unique", "unmapped", "paired", "distance"):
                self.stats[k] += my[k]
            return sam
        seeds_all = self._seeds_to_lists(
            n, self._seed_batch_flat([self._encode(r.seq) for r in chunk])
        )
        cands_all = self._device_cluster(states, seeds_all)
        if cands_all is None:
            cands_all = [gen_candidates_illumina(st.rlen, seeds, self.gidx, self.max_gaps)
                         for st, seeds in zip(states, seeds_all)]
        if pair_end and n % 2 == 0:
            est = self._est_distance()
            pairing_flags = self._device_pair(est, cands_all)
            for i in range(0, n, 2):
                j = i + 1
                st1, st2 = states[i], states[j]
                cands1, cands2 = cands_all[i], cands_all[j]
                if pairing_flags is not None:
                    pairing = pairing_flags[i // 2]
                else:
                    pairing = check_paired_candidates(est, cands1, cands2)
                if not pairing:
                    pairing = rescue_unpaired(
                        self.gidx, est, self.max_insert_size, self.max_gaps,
                        st1, st2, cands1, cands2,
                    )
                if pairing:
                    remove_unmated_candidates(cands1, cands2)
                remove_redundant_candidates(cands1, pacbio=False)
                remove_redundant_candidates(cands2, pacbio=False)
            self._batch_nw([(i % 2 == 0, states[i], cands_all[i]) for i in range(n)])
            for i in range(0, n, 2):
                j = i + 1
                st1, st2 = states[i], states[j]
                gen_mapping_report(
                    self.gidx, self.conquer, True, st1, cands_all[i], False, self.multi_hit
                )
                gen_mapping_report(
                    self.gidx, self.conquer, False, st2, cands_all[j], False, self.multi_hit
                )
                check_paired_final_alignments(st1, st2, self.multi_hit)
                set_paired_flags(st1, st2)
                evaluate_mapq(st1, pacbio=False)
                evaluate_mapq(st2, pacbio=False)
            self.conquer.nw_memo = None
            for i in range(0, n, 2):
                sam.extend(
                    output_paired(self.gidx, states[i], states[i + 1], fastq, self.multi_hit, my)
                )
        else:
            for cands in cands_all:
                remove_redundant_candidates(cands, pacbio=False)
            self._batch_nw([(True, states[i], cands_all[i]) for i in range(n)])
            for i, st in enumerate(states):
                gen_mapping_report(
                    self.gidx, self.conquer, True, st, cands_all[i], False, self.multi_hit
                )
                set_single_flag(st)
                evaluate_mapq(st, pacbio=False)
            self.conquer.nw_memo = None
            for st in states:
                sam.extend(output_single(self.gidx, st, fastq, self.multi_hit, my))
        self.stats["total"] += n
        for k in ("unique", "unmapped", "paired", "distance"):
            self.stats[k] += my[k]
        return sam

    def _device_cluster(self, states, seeds_all):
        """The Illumina candidates of a chunk clustered on the device
        (KART_DEVICE_CLUSTER=1, read at every call as kart_tpu reads it);
        None where the switch is off and the host clusters."""
        if os.environ.get("KART_DEVICE_CLUSTER") != "1":
            return None
        check_int32_index(self.gidx, "device clustering")
        return cluster_batch_to_candidates(
            self.gidx, seeds_all, [st.rlen for st in states], self.max_gaps, device=self.device
        )

    def _device_pair(self, est: int, cands_all: list):
        """The paired-end candidates of a chunk mated on the device
        (KART_DEVICE_PAIR=1, read at every call): the pairs' flags, with
        paired_idx written into the candidates; None where the switch is off
        and the host mates them.  The reference's pre-prune of a pair whose
        candidate product is over 1000 (Mapping.cpp:356-360) runs on the
        host first."""
        if os.environ.get("KART_DEVICE_PAIR") != "1":
            return None
        check_int32_index(self.gidx, "device pairing")
        pairs = []
        for i in range(0, len(cands_all), 2):
            c1, c2 = cands_all[i], cands_all[i + 1]
            if len(c1) * len(c2) > 1000:
                remove_redundant_candidates(c1, pacbio=False)
                remove_redundant_candidates(c2, pacbio=False)
            pairs.append((c1, c2))
        return pair_chunk_on_device(est, pairs, device=self.device)

    def map_chunks(self, chunks: list, pair_end: bool, fastq: bool) -> list[str]:
        """Map several 4000-read chunks in order (per-chunk pairing sees the
        running insert-size stats in reference order).  Where the native
        backend seeds here (FastMode through the sharded index), every
        chunk's reads are seeded in one call, then each chunk is mapped by
        the C++ engine."""
        chunks = [c for c in chunks if c]
        if (self.native is None or self.pacbio or len(chunks) <= 1
                or self._native_seeding_ready()):
            out: list[str] = []
            for c in chunks:
                out.extend(self.map_chunk(c, pair_end, fastq))
            return out
        all_reads = [r for c in chunks for r in c]
        cnts, rp, ln, gp = self._seed_batch_flat([self._encode(r.seq) for r in all_reads])
        read_off = np.concatenate([[0], np.cumsum([len(c) for c in chunks])])
        seed_off = np.concatenate([[0], np.cumsum(cnts)])
        out = []
        for ci, c in enumerate(chunks):
            r0, r1 = read_off[ci], read_off[ci + 1]
            s0, s1 = seed_off[r0], seed_off[r1]
            sam_text = self.native.process_chunk(
                c, pair_end and len(c) % 2 == 0, fastq, cnts[r0:r1], rp[s0:s1], ln[s0:s1],
                gp[s0:s1], self.stats)
            self.stats["total"] += len(c)
            out.extend(sam_text.decode("ascii").splitlines())
        return out

    # ------------------------------------------------------------------
    # Device-pipelined stream (KART_SEED_MODE=device)
    # ------------------------------------------------------------------

    def _occ_budget(self, B: int, l_max: int) -> int:
        """Occurrence slots of a group's resolved stream; reads that overrun
        it are re-seeded.  Illumina: KART_OCC_BUDGET (read at every call)
        times B.  PacBio: max(64, l_max // 24) a lane, kart_tpu's figure,
        with no override."""
        if self.pacbio:
            return B * max(64, l_max // 24)
        return int(os.environ.get("KART_OCC_BUDGET", "3")) * B

    def _pack16(self, l_max: int) -> bool:
        """16-bit stream packing is exact for l_max <= 256 (rpos < 256,
        slen <= 256) on an int32 index; an int64 index keeps the 32-bit
        layout."""
        return l_max <= 256 and self.gidx.index_dtype is np.int32

    def _max_seeds(self, l_max: int) -> int:
        if self.pacbio:
            return l_max // self.min_seed_len + 2
        return l_max // (self.min_seed_len + 1) + 1

    def _funnel_rounds(self, l_max: int) -> int:
        """The funnel's round limit for a group: a SensitiveMode round
        restarts every lane once, so a read takes about rlen / MinSeed rounds."""
        return l_max // self.min_seed_len + 8 if self.pacbio else l_max // 10 + 4

    def _to_device(self, arrays):
        """numpy arrays -> tensors on the mapper's device.  On a CUDA device
        the copies go through pinned memory without blocking, on the
        current stream; the pinned tensors are returned to be kept alive
        until the stream has passed them."""
        host = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a) for a in arrays]
        if self.device.type != "cuda":
            return host, ()
        pinned = [t.pin_memory() for t in host]
        return [t.to(self.device, non_blocking=True) for t in pinned], pinned

    def _seed_resolved(self, words, amb_r, amb_p, rlens, l_max: int, B: int, seq=None):
        """One group's packed resolved stream on the device: the funnel when
        the tables pass the gate, else the FM stepper; for PacBio reads the
        SensitiveMode form of either.  Recorded as the span `kart.seed`
        (tagged with the group's sequence number `seq`)."""
        with span("kart.seed", seq):
            kw = dict(max_seeds=self._max_seeds(l_max), l_max=l_max,
                      occ_budget=self._occ_budget(B, l_max), pack16=self._pack16(l_max))
            tb = self._get_kmer_tables()
            if tb is not None:
                return kmer_seed_scan_resolved_packed(
                    self._device_tables(), words, amb_r, amb_p, rlens, self.min_seed_len,
                    hit_cap=hit_cap_for(tb.max_mult), rounds=self._funnel_rounds(l_max),
                    sensitive=self.pacbio, **kw,
                )
            fn = sensitive_scan_resolved_packed if self.pacbio else seed_scan_resolved_packed
            return fn(self.fm, self._device_sa(), words, amb_r, amb_p, rlens, self.min_seed_len,
                      sa_mode=self._device_sa_mode(), **kw)

    def _dispatch_seed_async(self, reads_i8, rl, l_max, seq=None):
        """Pack a (B, l_max) int8 group to 2 bits and seed it.  On a CUDA
        device everything is queued on the mapper's stream (pinned uploads,
        the kernels, a pinned download) and an event marks its end; on the
        CPU the plain versions run now.  Returns the pending entry, with
        `upload_bytes`, the bytes of the arrays handed to _to_device, and
        `amb_entries`, the ambiguity list's real entries (its runs).  The
        stages are the spans `kart.pack`, `kart.upload`, `kart.seed` and
        `kart.download`, tagged with the group's sequence number `seq`."""
        with span("kart.pack", seq):
            arrays = pack_reads_2bit(reads_i8) + (rl,)
        up = sum(a.nbytes for a in arrays)
        B = reads_i8.shape[0]
        amb = int(np.count_nonzero(arrays[1] < B))  # the capacity pads carry row B
        if self.device.type != "cuda":
            with span("kart.upload", seq):
                (w, ar, ap, r), _ = self._to_device(arrays)
            return dict(host=self._seed_resolved(w, ar, ap, r, l_max, B, seq), event=None,
                        keep=(), seq=seq, upload_bytes=up, amb_entries=amb)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._device_sa()  # the tables' uploads precede the first group
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            with span("kart.upload", seq):
                (w, ar, ap, r), pinned = self._to_device(arrays)
            stream = self._seed_resolved(w, ar, ap, r, l_max, B, seq)
            with span("kart.download", seq):
                # one int32 array, or an int64 index's (cnts, meta, gpos)
                parts = stream if isinstance(stream, tuple) else (stream,)
                host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in parts)
                for h, t in zip(host, parts):
                    h.copy_(t, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
        if not isinstance(stream, tuple):
            host = host[0]
        return dict(host=host, event=event, keep=(pinned, w, ar, ap, r, stream), seq=seq,
                    upload_bytes=up, amb_entries=amb)

    def _host_fm(self):
        """The host FM model (ops/fm_ref.py, sampled SA), made at first use."""
        from ..ops.fm_ref import fm_from_genome_index

        if not hasattr(self, "_fm_ref"):
            self._fm_ref = fm_from_genome_index(self.gidx)
        return self._fm_ref

    def _reseed_host_flat(self, enc: np.ndarray):
        """Exact host re-seed of one read through the host FM model:
        emission-order (rpos, len, gpos) tuples."""
        from ..ops.fm_ref import identify_seed_pairs_fast

        if self.pacbio:
            return self._seed_sensitive_flat(enc)
        return identify_seed_pairs_fast(self._host_fm(), enc, self.min_seed_len)

    def _reseed_device_flat(self, bad, reads_i8, rl, l_max) -> dict:
        """Exact re-seed of flagged lanes as one device batch through the FM
        stepper (SensitiveMode for PacBio), with 64 occurrence slots per
        lane (PacBio: the group's budget per lane); a read that overruns
        even those is re-seeded on the host."""
        nb = len(bad)
        pack16 = self._pack16(l_max)
        Bb = _bucket(nb, _PB_B_BUCKETS if self.pacbio else _B_BUCKETS)
        if pack16:
            Bb += Bb & 1  # past the last bucket the batch is nb itself: pack16 pairs lanes
        reads_b = np.full((Bb, l_max), 4, dtype=np.int8)
        reads_b[:nb] = reads_i8[bad]
        rl_b = np.zeros(Bb, dtype=np.int32)
        rl_b[:nb] = rl[bad]
        budget = self._occ_budget(Bb, l_max) if self.pacbio else Bb * 64
        (w, ar, ap, r), _pinned = self._to_device(pack_reads_2bit(reads_b) + (rl_b,))
        fn = sensitive_scan_resolved_packed if self.pacbio else seed_scan_resolved_packed
        stream = fn(
            self.fm, self._device_sa(), w, ar, ap, r, self.min_seed_len,
            max_seeds=self._max_seeds(l_max), l_max=l_max, occ_budget=budget,
            sa_mode=self._device_sa_mode(), pack16=pack16,
        )
        cnts, meta, gpos = unpack_stream(_host_arrays(stream), Bb, budget, pack16)
        ok, tot, offs = decode_resolved_counts(cnts)
        out = {}
        n_host = 0
        for j, i in enumerate(bad):
            if ok[j]:
                seg = slice(int(offs[j]), int(offs[j + 1]))
                out[int(i)] = [
                    (int(m & 0xFFFF), int(m >> 16) & 0xFFFF, int(g))
                    for m, g in zip(meta[seg], gpos[seg])
                ]
            else:
                n_host += 1
                out[int(i)] = self._reseed_host_flat(reads_i8[i, : rl[i]].astype(np.int32))
        self.group_log[-1].update(reseeded_device=nb - n_host, reseeded_host=n_host)
        return out

    def _finalize_seed(self, entry, n, reads_i8, rl, l_max):
        """Wait for a dispatched group and decode its stream -> (tot, offs,
        rpos, slen, gpos, overrides): flat per-occurrence arrays plus the
        exact re-seeds of flagged reads.  The group's group_log entry counts
        its reads, flagged lanes, re-seeds, `upload_bytes`, `amb_entries`
        and the downloaded stream's `stream_bytes`.  The stages are the spans
        `kart.wait`, `kart.decode` and `kart.reseed`."""
        seq = entry.get("seq")
        if entry["event"] is not None:
            with span("kart.wait", seq):
                entry["event"].synchronize()
        B = reads_i8.shape[0]
        with span("kart.decode", seq):
            arrs = _host_arrays(entry["host"])
            cnts, meta, gpos = unpack_stream(arrs, B, self._occ_budget(B, l_max),
                                             self._pack16(l_max))
            ok, tot, offs = decode_resolved_counts(cnts)
            rpos = (meta & 0xFFFF).astype(np.int32)
            slen = ((meta >> 16) & 0xFFFF).astype(np.int32)  # logical: slen 32768 sets the sign bit
            bad = np.nonzero(~ok[:n])[0]
        stream_bytes = sum(a.nbytes for a in (arrs if isinstance(arrs, tuple) else (arrs,)))
        self.group_log.append(dict(reads=n, flagged=len(bad), reseeded_device=0, reseeded_host=0,
                                   upload_bytes=entry["upload_bytes"],
                                   amb_entries=entry["amb_entries"], stream_bytes=stream_bytes))
        overrides = {}
        if len(bad):
            with span("kart.reseed", seq):
                overrides = self._reseed_device_flat(bad, reads_i8, rl, l_max)
        return tot, offs, rpos, slen, gpos, overrides

    @staticmethod
    def _chunk_flat(res, r0, r1):
        """Slice the resolved stream for reads [r0, r1) -> per-chunk (cnt,
        rpos, slen, gpos) arrays, splicing in the re-seeds."""
        tot, offs, rpos, slen, gpos, overrides = res
        s0, s1 = int(offs[r0]), int(offs[r1])
        keys = [i for i in overrides if r0 <= i < r1]
        if not keys:
            return tot[r0:r1], rpos[s0:s1], slen[s0:s1], gpos[s0:s1].astype(np.int64)
        cnt = tot[r0:r1].copy()
        rp_parts, ln_parts, gp_parts = [], [], []
        for i in range(r0, r1):
            if i in overrides:
                tuples = overrides[i]
                cnt[i - r0] = len(tuples)
                if tuples:
                    a = np.array(tuples, dtype=np.int64)
                    rp_parts.append(a[:, 0].astype(np.int32))
                    ln_parts.append(a[:, 1].astype(np.int32))
                    gp_parts.append(a[:, 2])
            else:
                seg = slice(int(offs[i]), int(offs[i + 1]))
                rp_parts.append(rpos[seg])
                ln_parts.append(slen[seg])
                gp_parts.append(gpos[seg].astype(np.int64))

        def cat(parts, dt):
            return np.concatenate(parts) if parts else np.zeros(0, dt)

        return cnt, cat(rp_parts, np.int32), cat(ln_parts, np.int32), cat(gp_parts, np.int64)

    @staticmethod
    def _read_group(reader, G):
        group = []
        while len(group) < G:
            n, ptrs = reader.next_chunk()
            if n == 0:
                break
            group.append((n, ptrs))
        return group

    def _encode_group(self, group, l_buckets, b_buckets):
        """Encode G reader chunks into one (B, l_max) int8 batch (codes,
        padded 4) and (B,) rlens."""
        total = sum(n for n, _ in group)
        l_raw = 0
        for n, ptrs in group:
            off = np.ctypeslib.as_array(
                ctypes.cast(ptrs[1], ctypes.POINTER(ctypes.c_int64)), shape=(n + 1,)
            )
            l_raw = max(l_raw, int(np.diff(off).max()))
        l_max = _bucket(l_raw, l_buckets)
        B = _bucket(total, b_buckets)
        reads = np.full((B, l_max), 4, dtype=np.int8)
        rlens = np.zeros(B, dtype=np.int32)
        row = 0
        for n, ptrs in group:
            self.native.encode_reads_into(n, ptrs, reads, rlens, row, l_max)
            row += n
        return reads, rlens, l_max

    def _map_stream_device(self, path1, path2, pair_end, fastq, writer, progress=None) -> None:
        """Depth-2 pipeline: group k seeds on the device while group k-1's
        stream comes down and group k-2 is mapped on the host."""
        from ..native.post import NativeReader

        # PacBio chunks hold 10 reads: a group needs many of them to fill
        # the card and to spread the funnel's cost per round
        l_buckets = _PB_L_BUCKETS if self.pacbio else _L_BUCKETS
        G = max(1, int(os.environ.get("KART_DEVICE_GROUP", "64" if self.pacbio else "8")))
        chunk_sz = _PB_CHUNK if self.pacbio else _CHUNK
        b_buckets = sorted(set((_PB_B_BUCKETS if self.pacbio else _B_BUCKETS) + [G * chunk_sz]))
        depth = max(1, int(os.environ.get("KART_DEVICE_DEPTH", "2")))
        # ring: depth groups in flight + the group being mapped + prefetch
        reader = NativeReader(path1, path2, fastq, pair_end, self.pacbio,
                              n_bufs=(depth + 2) * G + 2)

        def post(entry):
            group, seq = entry["group"], entry["seq"]
            n_tot = sum(n for n, _ in group)
            res = self._finalize_seed(entry, n_tot, entry["reads"], entry["rlens"], entry["l_max"])
            row = 0
            for n0, ptrs0 in group:
                if progress is not None:
                    progress(self.stats["total"])
                with span("kart.post", seq):
                    cnt, rp, ln, gp = self._chunk_flat(res, row, row + n0)
                    text = self.native.process_chunk_flat(
                        n0, pair_end and n0 % 2 == 0 and not self.pacbio, fastq, ptrs0, cnt, rp,
                        ln, gp, self.stats
                    )
                with span("kart.write", seq):
                    writer(text)
                self.stats["total"] += n0
                row += n0

        try:
            pend: list = []
            eof = False
            seq = 0  # the groups' sequence numbers tag their spans
            while not eof or pend:
                if not eof:
                    with span("kart.read", seq):
                        group = self._read_group(reader, G)
                    if group:
                        with span("kart.encode", seq):
                            reads_i8, rl, l_max = self._encode_group(group, l_buckets, b_buckets)
                        entry = self._dispatch_seed_async(reads_i8, rl, l_max, seq)
                        entry.update(group=group, reads=reads_i8, rlens=rl, l_max=l_max)
                        pend.append(entry)
                        seq += 1
                    else:
                        eof = True
                if pend and (eof or len(pend) > depth):
                    post(pend.pop(0))
        finally:
            reader.close()

    # ------------------------------------------------------------------
    # Native (host C++) stream
    # ------------------------------------------------------------------

    def _native_seeding_ready(self) -> bool:
        """Give the C++ engine its seeding index: the funnel's tables where
        the gate passes, else the FM index; False (the engine does not seed)
        with the sharded index, whose seeding it would bypass, and in the
        python backend."""
        if self.native is None:
            return False
        tb = self._get_kmer_tables()
        if tb is not None:
            if not getattr(self.native, "has_seed_tables", False):
                self.native.set_seed_tables(tb)
            return True
        if self.idx_shards > 1:
            return False
        if not getattr(self.native, "has_fm_index", False):
            self.native.set_fm_index(self.gidx)
        return True

    def _map_stream_native(self, path1, path2, pair_end, fastq, writer, progress=None) -> None:
        from ..native.post import NativeReader

        reader = NativeReader(path1, path2, fastq, pair_end, self.pacbio)
        try:
            while True:
                n, ptrs = reader.next_chunk()
                if n == 0:
                    break
                if progress is not None:
                    progress(self.stats["total"])
                writer(self.native.process_chunk_ptrs(n, pair_end, fastq, ptrs, self.stats))
                self.stats["total"] += n
        finally:
            reader.close()

    def prepare(self) -> None:
        """Make the chosen mode's state before the first read: the native
        engine's seeding index, for KART_SEED_MODE=device the kernel
        library, the funnel's tables, the FM index and the full SA on the
        device (neither of the last two in the sampled SA mode), and for the
        python backend the kernel library and, where the FastMode funnel
        seeds, its tables on the device and the host packer of its reads;
        with the sharded index, the kernel library and the index's slabs on
        their devices (PacBio: the replicated FM index).  map_stream makes
        whatever is missing itself."""
        device_mode = os.environ.get("KART_SEED_MODE", "native") == "device"
        if self.backend == "python" or not (device_mode or self._native_seeding_ready()):
            # the chunks are seeded here (map_chunks)
            if self.device.type == "cuda":
                from .. import kernels

                kernels.build()
            if self.idx_shards > 1:
                _ = self.fm if self.pacbio else self._get_sharded()
            elif not self.pacbio and self._get_kmer_tables() is not None:
                if self.device.type == "cuda":
                    from ..native.post import load_postlib

                    self._device_tables()
                    load_postlib()
            return
        if not device_mode:
            return
        if self.device.type == "cuda":
            from .. import kernels

            kernels.build()
        self._device_sa()
        _ = self.fm  # the re-seed batches' FM index
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def map_stream(self, path1: str, path2: str | None, pair_end: bool,
                   fastq: bool, writer, progress=None) -> None:
        """Map one whole library (file or file pair), streaming SAM text to
        `writer`: device-pipelined with KART_SEED_MODE=device, else the
        native engine where it seeds, else (the sharded index) the python
        reader; the python backend ignores KART_SEED_MODE, as kart_tpu's
        does."""
        if self.backend == "python":
            return self._map_stream_chunks(path1, path2, pair_end, fastq, writer, progress)
        if os.environ.get("KART_SEED_MODE", "native") == "device":
            return self._map_stream_device(path1, path2, pair_end, fastq, writer, progress)
        if self._native_seeding_ready():
            return self._map_stream_native(path1, path2, pair_end, fastq, writer, progress)
        return self._map_stream_chunks(path1, path2, pair_end, fastq, writer, progress)

    def _map_stream_chunks(self, path1, path2, pair_end, fastq, writer, progress=None) -> None:
        """The python reader, four chunks at a time through map_chunks: the
        python backend, and the native backend where its engine does not
        seed."""
        s1 = ReadStream(path1, fastq)
        s2 = ReadStream(path2, fastq) if path2 else None
        try:
            done = False
            while not done:
                group = []
                while len(group) < 4:
                    chunk = next_chunk(s1, s2, pair_end, self.pacbio)
                    if not chunk:
                        done = True
                        break
                    group.append(chunk)
                if not group:
                    break
                if progress is not None:
                    progress(self.stats["total"])
                for line in self.map_chunks(group, pair_end, fastq):
                    writer(line + "\n")
        finally:
            s1.close()
            if s2:
                s2.close()

