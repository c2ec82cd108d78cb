"""Chunk mapper of the port.

Counterpart of kart_tpu's KartMapper (`kart_tpu/pipeline/mapper.py`) for
Illumina reads, in three modes:

* native (the default backend): the host C++ engine (native/post.py) seeds and maps
  every chunk (`NativeReader` + `process_chunk_ptrs`); no device is used.
* device-pipelined (`KART_SEED_MODE=device`, native backend): groups of G
  reader chunks are encoded and 2-bit packed on the host, seeded on the
  device by the 13-mer funnel (or by the FM stepper when the tables fail
  kart_tpu's gate), expanded and resolved through the full SA and packed
  into one int32 stream there, downloaded, and mapped by the C++ engine
  (`process_chunk_flat`).  Lanes that the funnel or the occurrence budget
  flag are re-seeded exactly by the FM stepper.  On a CUDA device each
  group is one stream of pinned uploads, kernels and a pinned download,
  ended by an event, so group k seeds while group k-1 is mapped on the
  host; with `-cpu` the plain versions run in line.  A device or kernel
  error raises: there is no fall-back to the host engine.
* python backend (`-backend python`): device FastMode seeding
  (`ops/fm_search.seed_scan`), host divide and report, every NW fragment
  of a chunk as one device batch (`ops/nw.nw_align_batch`).
"""

from __future__ import annotations

import copy
import ctypes
import os

import numpy as np
import torch

from ..index.format import NT4_TABLE
from ..index.loader import GenomeIndex
from ..io.fastq import RawRead, ReadStream, next_chunk
from ..ops.fm_search import FMIndexTensors, seed_scan, unpack_seed_scan
from ..ops.kmer_seed import KmerTablesTensors, build_tables, hit_cap_for
from ..ops.nw import nw_align_batch
from ..ops.pack import (
    kmer_seed_scan_resolved_packed,
    pack_reads_2bit,
    seed_scan_resolved_packed,
    unpack_stream,
)
from ..ops.resolve import decode_resolved_counts
from .candidates import (
    Seed,
    gen_candidates_illumina,
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
# The python backend does not pad the batch (its rows are independent).
_B_BUCKETS = [2048, 16000]
_L_BUCKETS = [64, 128, 160, 256, 384, 512]
_CHUNK = 4000  # reads per reader chunk (kart_tpu's native reader)

# environment switches of kart_tpu that select paths not ported yet
_UNPORTED_ENV = (
    ("KART_SA_MODE", "sampled", "sampled-SA resolution, ROADMAP Queue 1 item 8"),
    ("KART_DEVICE_CLUSTER", "1", "device clustering, ROADMAP Queue 1 item 9"),
    ("KART_DEVICE_PAIR", "1", "device pairing, ROADMAP Queue 1 item 9"),
)


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


class TorchKartMapper:
    """Illumina single- and paired-end mapping on one torch device.

    `device` "cuda" runs the CUDA kernels; "cpu" runs their plain versions.
    `backend` "native" maps with the C++ engine (seeding on the host,
    or on the device with KART_SEED_MODE=device); "python" runs the python
    pipeline around device seeding and device NW."""

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
    ):
        if pacbio:
            raise NotImplementedError("-pacbio is not ported yet (ROADMAP Queue 1 item 7)")
        for var, value, what in _UNPORTED_ENV:
            if os.environ.get(var) == value:
                raise NotImplementedError(f"{var}={value}: {what}, is not ported yet")
        if gidx.seq_len >= 2**31:
            raise NotImplementedError(
                "int64 FM-index (seq_len >= 2**31) is not ported yet "
                "(ROADMAP Queue 1 item 8, frugal and human-scale slice)"
            )
        if backend not in ("native", "python"):
            raise ValueError(f"unknown backend {backend!r}")
        self.device = torch.device(device)
        self.gidx = gidx
        self.backend = backend
        self.max_gaps = max_gaps
        self.max_insert_size = max_insert_size
        self.multi_hit = multi_hit
        self.min_seed_len = compute_min_seed_length(gidx.two_genome_size)
        self.conquer = Conquer(gidx.ref_seq, False, max_gaps)
        self.sa_full_np = gidx.sa_full
        # device arrays are made at first use: the native mode never needs them
        self._fm = None
        self._tables = None
        self._tables_tried = False
        self._tables_dev = None
        self._sa_dev = None
        self._stream = None
        self.native = None
        if backend == "native":
            from ..native.post import NativePostProcessor

            self.native = NativePostProcessor(
                gidx, False, max_gaps, max_insert_size, self.min_seed_len, multi_hit,
                n_threads=n_threads, debug=debug,
            )
        # shared counters (reference: Mapping.cpp:20)
        self.stats = dict(total=0, unique=0, unmapped=0, paired=0, distance=0)
        # device-pipelined mode, one entry per dispatch group: reads, lanes
        # flagged by the funnel or the budget, and how they were re-seeded
        self.group_log: list[dict] = []

    @property
    def fm(self) -> FMIndexTensors:
        if self._fm is None:
            self._fm = FMIndexTensors.from_genome_index(self.gidx, self.device)
        return self._fm

    def _get_kmer_tables(self):
        """kart_tpu's gate for the 13-mer funnel: genome at most
        KART_KMER_GATE bases, every 4-mer present (exact sub-13 restarts),
        13-mer multiplicity at most 4096.  None when the gate refuses."""
        if self._tables_tried:
            return self._tables
        self._tables_tried = True
        gate = int(os.environ.get("KART_KMER_GATE", "1200000000"))
        if self.gidx.seq_len > gate:
            return None
        tb = build_tables(self.gidx)
        if tb.all_short_present and tb.max_mult <= 4096:
            self._tables = tb
        return self._tables

    def _device_tables(self) -> KmerTablesTensors:
        if self._tables_dev is None:
            self._tables_dev = KmerTablesTensors.from_tables(self._get_kmer_tables(), self.device)
        return self._tables_dev

    def _device_sa(self) -> torch.Tensor:
        """The full SA on the device (the funnel tables' copy when they exist)."""
        if self._sa_dev is None:
            if self._get_kmer_tables() is not None:
                self._sa_dev = self._device_tables().sa_full
            else:
                sa = np.ascontiguousarray(self.sa_full_np, dtype=np.int32)
                self._sa_dev = torch.from_numpy(sa).to(self.device)
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
        its PosDiff sort)."""
        n = len(enc_reads)
        empty = (
            np.zeros(n, np.int32),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            np.zeros(0, np.int64),
        )
        if n == 0:
            return empty
        rlens = np.array([len(e) for e in enc_reads], dtype=np.int32)
        l_max = _bucket(int(rlens.max()), _L_BUCKETS)
        reads = np.full((n, l_max), 4, dtype=np.int32)
        for i, e in enumerate(enc_reads):
            reads[i, : len(e)] = e[:l_max]
        max_seeds = l_max // (self.min_seed_len + 1) + 1
        packed = seed_scan(
            self.fm,
            torch.from_numpy(reads).to(self.device),
            torch.from_numpy(rlens).to(self.device),
            self.min_seed_len,
            max_seeds=max_seeds,
            l_max=l_max,
        ).cpu().numpy()
        out = unpack_seed_scan(packed, max_seeds)
        n_seeds, rpos, slen = out["n_seeds"], out["rpos"], out["slen"]
        k0, freq = out["k0"], out["freq"]

        # flatten all occurrences, resolve with one full-SA gather
        sidx = np.arange(max_seeds)[None, :] < n_seeds[:, None]
        f = np.where(sidx, freq, 0)
        reps = f.reshape(-1)
        total = int(reps.sum())
        if total == 0:
            return empty
        base = np.repeat(k0.reshape(-1).astype(np.int64), reps)
        cum = np.cumsum(reps)
        offs = np.arange(total) - np.repeat(cum - reps, reps)
        locs = self.sa_full_np[base + offs].astype(np.int64)
        rp_flat = np.repeat(rpos.reshape(-1), reps).astype(np.int32)
        ln_flat = np.repeat(slen.reshape(-1), reps).astype(np.int32)
        cnts = f.sum(axis=1).astype(np.int32)
        return cnts, rp_flat, ln_flat, locs

    def _seeds_to_lists(self, n, flat) -> list[list[Seed]]:
        """Flat seed arrays -> per-read Seed lists sorted by (PosDiff, rpos)."""
        cnts, rp, ln, gp = flat
        result: list[list[Seed]] = []
        base = 0
        for i in range(n):
            seeds = [
                Seed(True, int(rp[base + t]), int(gp[base + t]), int(ln[base + t]),
                     int(ln[base + t]), int(gp[base + t]) - int(rp[base + t]))
                for t in range(int(cnts[i]))
            ]
            seeds.sort(key=lambda s: (s.posdiff, s.rpos))
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
                    copy.deepcopy(cands), False, self.multi_hit,
                )
        finally:
            self.conquer.collecting = None
        pairs = sorted(keys)  # deterministic batch order
        self.conquer.nw_memo = dict(zip(pairs, nw_align_batch(pairs, device=self.device)))

    def map_chunk(self, chunk: list[RawRead], pair_end: bool, fastq: bool) -> list[str]:
        n = len(chunk)
        if n == 0:
            return []
        sam: list[str] = []
        my = dict(unique=0, unmapped=0, paired=0, distance=0)
        seeds_all = self._seeds_to_lists(
            n, self._seed_batch_flat([self._encode(r.seq) for r in chunk])
        )
        states = [self._make_state(r) for r in chunk]
        if pair_end and n % 2 == 0:
            est = self._est_distance()
            cands_all: list = [None] * n
            for i in range(0, n, 2):
                j = i + 1
                st1, st2 = states[i], states[j]
                cands1 = gen_candidates_illumina(st1.rlen, seeds_all[i], self.gidx, self.max_gaps)
                cands2 = gen_candidates_illumina(st2.rlen, seeds_all[j], self.gidx, self.max_gaps)
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
                cands_all[i], cands_all[j] = cands1, cands2
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
            cands_all = []
            for i, st in enumerate(states):
                cands = gen_candidates_illumina(st.rlen, seeds_all[i], self.gidx, self.max_gaps)
                remove_redundant_candidates(cands, pacbio=False)
                cands_all.append(cands)
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

    def map_chunks(self, chunks: list, pair_end: bool, fastq: bool) -> list[str]:
        """Map several 4000-read chunks in order (per-chunk pairing sees the
        running insert-size stats in reference order)."""
        out: list[str] = []
        for c in chunks:
            out.extend(self.map_chunk(c, pair_end, fastq))
        return out

    # ------------------------------------------------------------------
    # Device-pipelined stream (KART_SEED_MODE=device)
    # ------------------------------------------------------------------

    def _occ_budget(self, B: int) -> int:
        """Occurrence slots of a group's resolved stream (FastMode):
        KART_OCC_BUDGET (read at every call) times B; reads that overrun it
        are re-seeded."""
        return int(os.environ.get("KART_OCC_BUDGET", "3")) * B

    def _pack16(self, l_max: int) -> bool:
        """16-bit stream packing is exact for l_max <= 256 on an int32
        index (rpos < 256, slen <= 256)."""
        return l_max <= 256

    def _max_seeds(self, l_max: int) -> int:
        return l_max // (self.min_seed_len + 1) + 1

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

    def _seed_resolved(self, words, amb_r, amb_p, rlens, l_max: int, B: int):
        """One group's packed resolved stream on the device: the funnel when
        the tables pass the gate, else the FM stepper."""
        kw = dict(max_seeds=self._max_seeds(l_max), l_max=l_max,
                  occ_budget=self._occ_budget(B), pack16=self._pack16(l_max))
        tb = self._get_kmer_tables()
        if tb is not None:
            return kmer_seed_scan_resolved_packed(
                self._device_tables(), words, amb_r, amb_p, rlens, self.min_seed_len,
                hit_cap=hit_cap_for(tb.max_mult), rounds=l_max // 10 + 4, **kw,
            )
        return seed_scan_resolved_packed(
            self.fm, self._device_sa(), words, amb_r, amb_p, rlens, self.min_seed_len, **kw
        )

    def _dispatch_seed_async(self, reads_i8, rl, l_max):
        """Pack a (B, l_max) int8 group to 2 bits and seed it.  On a CUDA
        device everything is queued on the mapper's stream (pinned uploads,
        the kernels, a pinned download) and an event marks its end; on the
        CPU the plain versions run now.  Returns the pending entry."""
        words, amb_r, amb_p = pack_reads_2bit(reads_i8)
        B = reads_i8.shape[0]
        if self.device.type != "cuda":
            (w, ar, ap, r), _ = self._to_device((words, amb_r, amb_p, rl))
            return dict(host=self._seed_resolved(w, ar, ap, r, l_max, B), event=None, keep=())
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._device_sa()  # the tables' uploads precede the first group
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            (w, ar, ap, r), pinned = self._to_device((words, amb_r, amb_p, rl))
            stream = self._seed_resolved(w, ar, ap, r, l_max, B)
            host = torch.empty(stream.shape, dtype=torch.int32, pin_memory=True)
            host.copy_(stream, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return dict(host=host, event=event, keep=(pinned, w, ar, ap, r, stream))

    def _reseed_host_flat(self, enc: np.ndarray):
        """Exact host re-seed of one read through the host FM model (ops/fm_ref.py)
        (sampled SA): emission-order (rpos, len, gpos) tuples."""
        from ..ops.fm_ref import fm_from_genome_index, identify_seed_pairs_fast

        if not hasattr(self, "_fm_ref"):
            self._fm_ref = fm_from_genome_index(self.gidx)
        return identify_seed_pairs_fast(self._fm_ref, enc, self.min_seed_len)

    def _reseed_device_flat(self, bad, reads_i8, rl, l_max) -> dict:
        """Exact re-seed of flagged lanes as one device batch through the FM
        stepper, with 64 occurrence slots per lane; a read that overruns
        even those is re-seeded on the host."""
        nb = len(bad)
        Bb = _bucket(nb, _B_BUCKETS)
        reads_b = np.full((Bb, l_max), 4, dtype=np.int8)
        reads_b[:nb] = reads_i8[bad]
        rl_b = np.zeros(Bb, dtype=np.int32)
        rl_b[:nb] = rl[bad]
        budget = Bb * 64
        pack16 = self._pack16(l_max)
        (w, ar, ap, r), _pinned = self._to_device(pack_reads_2bit(reads_b) + (rl_b,))
        stream = seed_scan_resolved_packed(
            self.fm, self._device_sa(), w, ar, ap, r, self.min_seed_len,
            max_seeds=self._max_seeds(l_max), l_max=l_max, occ_budget=budget, pack16=pack16,
        ).cpu().numpy()
        cnts, meta, gpos = unpack_stream(stream, Bb, budget, pack16)
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
        exact re-seeds of flagged reads."""
        if entry["event"] is not None:
            entry["event"].synchronize()
        B = reads_i8.shape[0]
        cnts, meta, gpos = unpack_stream(
            entry["host"].numpy(), B, self._occ_budget(B), self._pack16(l_max)
        )
        ok, tot, offs = decode_resolved_counts(cnts)
        rpos = (meta & 0xFFFF).astype(np.int32)
        slen = ((meta >> 16) & 0xFFFF).astype(np.int32)  # logical: slen 32768 sets the sign bit
        bad = np.nonzero(~ok[:n])[0]
        self.group_log.append(dict(reads=n, flagged=len(bad), reseeded_device=0, reseeded_host=0))
        overrides = self._reseed_device_flat(bad, reads_i8, rl, l_max) if len(bad) else {}
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

    def _encode_group(self, group, b_buckets):
        """Encode G reader chunks into one (B, l_max) int8 batch (codes,
        padded 4) and (B,) rlens."""
        total = sum(n for n, _ in group)
        l_raw = 0
        for n, ptrs in group:
            off = np.ctypeslib.as_array(
                ctypes.cast(ptrs[1], ctypes.POINTER(ctypes.c_int64)), shape=(n + 1,)
            )
            l_raw = max(l_raw, int(np.diff(off).max()))
        l_max = _bucket(l_raw, _L_BUCKETS)
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

        G = max(1, int(os.environ.get("KART_DEVICE_GROUP", "8")))
        b_buckets = sorted(set(_B_BUCKETS + [G * _CHUNK]))
        depth = max(1, int(os.environ.get("KART_DEVICE_DEPTH", "2")))
        # ring: depth groups in flight + the group being mapped + prefetch
        reader = NativeReader(path1, path2, fastq, pair_end, False, n_bufs=(depth + 2) * G + 2)

        def post(entry):
            group = entry["group"]
            n_tot = sum(n for n, _ in group)
            res = self._finalize_seed(entry, n_tot, entry["reads"], entry["rlens"], entry["l_max"])
            row = 0
            for n0, ptrs0 in group:
                if progress is not None:
                    progress(self.stats["total"])
                cnt, rp, ln, gp = self._chunk_flat(res, row, row + n0)
                writer(self.native.process_chunk_flat(
                    n0, pair_end and n0 % 2 == 0, fastq, ptrs0, cnt, rp, ln, gp, self.stats
                ))
                self.stats["total"] += n0
                row += n0

        try:
            pend: list = []
            eof = False
            while not eof or pend:
                if not eof:
                    group = self._read_group(reader, G)
                    if group:
                        reads_i8, rl, l_max = self._encode_group(group, b_buckets)
                        entry = self._dispatch_seed_async(reads_i8, rl, l_max)
                        entry.update(group=group, reads=reads_i8, rlens=rl, l_max=l_max)
                        pend.append(entry)
                    else:
                        eof = True
                if pend and (eof or len(pend) > depth):
                    post(pend.pop(0))
        finally:
            reader.close()

    # ------------------------------------------------------------------
    # Native (host C++) stream
    # ------------------------------------------------------------------

    def _native_seeding_ready(self) -> None:
        """Give the C++ engine its seeding index: the funnel's tables where
        the gate passes, else the FM index."""
        tb = self._get_kmer_tables()
        if tb is not None:
            if not getattr(self.native, "has_seed_tables", False):
                self.native.set_seed_tables(tb)
        elif not getattr(self.native, "has_fm_index", False):
            self.native.set_fm_index(self.gidx)

    def _map_stream_native(self, path1, path2, pair_end, fastq, writer, progress=None) -> None:
        from ..native.post import NativeReader

        self._native_seeding_ready()
        reader = NativeReader(path1, path2, fastq, pair_end, False)
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
        engine's seeding index, or for KART_SEED_MODE=device the kernel
        library, the funnel's tables, the FM index and the full SA on the
        device.  map_stream makes whatever is missing itself."""
        if self.backend != "native":
            return
        if os.environ.get("KART_SEED_MODE", "native") != "device":
            self._native_seeding_ready()
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
        native engine; the python backend ignores KART_SEED_MODE, as
        kart_tpu's does."""
        if self.backend == "python":
            return self._map_stream_python(path1, path2, pair_end, fastq, writer, progress)
        if os.environ.get("KART_SEED_MODE", "native") == "device":
            return self._map_stream_device(path1, path2, pair_end, fastq, writer, progress)
        return self._map_stream_native(path1, path2, pair_end, fastq, writer, progress)

    def _map_stream_python(self, path1, path2, pair_end, fastq, writer, progress=None) -> None:
        """The python backend: four reader chunks at a time."""
        s1 = ReadStream(path1, fastq)
        s2 = ReadStream(path2, fastq) if path2 else None
        try:
            done = False
            while not done:
                group = []
                while len(group) < 4:
                    chunk = next_chunk(s1, s2, pair_end, False)
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

