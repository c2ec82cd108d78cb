"""Chunk mapper of the port: device seeding and device NW around kart_tpu's
host divide, report, MAPQ and SAM stages.

Counterpart of the python-backend part of kart_tpu's KartMapper
(`kart_tpu/pipeline/mapper.py`): FastMode seeding runs on the device
(`ops/fm_search.seed_scan`), occurrences resolve by a host gather from the
full suffix array, candidates, pairing and rescue run on the host, every NW
fragment of a chunk runs as one device batch (`ops/nw.nw_align_batch`), and
the report pass reads its alignments from the primed conquer memo.

Seeding always uses the FM stepper, as kart_tpu does with its 13-mer funnel
gated off (KART_KMER_GATE=0); the funnel's lanes are re-seeded exactly by
the FM stepper anyway, so the SAM is the same.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from kart_tpu.index.format import NT4_TABLE
from kart_tpu.index.loader import GenomeIndex
from kart_tpu.io.fastq import RawRead, ReadStream, next_chunk
from kart_tpu.pipeline.candidates import (
    Seed,
    gen_candidates_illumina,
    remove_redundant_candidates,
)
from kart_tpu.pipeline.pairing import (
    check_paired_candidates,
    check_paired_final_alignments,
    remove_unmated_candidates,
    rescue_unpaired,
)
from kart_tpu.pipeline.report import ReadState, gen_mapping_report
from kart_tpu.pipeline.sam import (
    evaluate_mapq,
    output_paired,
    output_single,
    set_paired_flags,
    set_single_flag,
)

from ..ops.fm_search import FMIndexTensors, seed_scan, unpack_seed_scan
from ..ops.nw import nw_align_batch
from .conquer import Conquer

# kart_tpu's read-length buckets: l_max sets max_seeds, hence which seeds
# are dropped, so the port pads to the same l_max.  The batch is not padded:
# rows are independent, and a CUDA thread per read takes any B.
_L_BUCKETS = [64, 128, 160, 256, 384, 512]

# environment switches of kart_tpu that select paths not ported yet
_UNPORTED_ENV = (
    ("KART_SEED_MODE", "device", "device-pipelined mode, ROADMAP Queue 1 item 6"),
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

    `device` "cuda" runs the CUDA kernels; "cpu" runs their plain versions."""

    def __init__(
        self,
        gidx: GenomeIndex,
        *,
        device,
        pacbio: bool = False,
        max_gaps: int = 5,
        max_insert_size: int = 1500,
        multi_hit: bool = False,
    ):
        if pacbio:
            raise NotImplementedError("-pacbio is not ported yet (ROADMAP Queue 1 item 7)")
        for var, value, what in _UNPORTED_ENV:
            if os.environ.get(var) == value:
                raise NotImplementedError(f"{var}={value}: {what}, is not ported yet")
        self.device = torch.device(device)
        self.gidx = gidx
        self.max_gaps = max_gaps
        self.max_insert_size = max_insert_size
        self.multi_hit = multi_hit
        self.min_seed_len = compute_min_seed_length(gidx.two_genome_size)
        self.conquer = Conquer(gidx.ref_seq, False, max_gaps)
        self.fm = FMIndexTensors.from_genome_index(gidx, self.device)
        self.sa_full_np = gidx.sa_full
        # shared counters (reference: Mapping.cpp:20)
        self.stats = dict(total=0, unique=0, unmapped=0, paired=0, distance=0)

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

    def map_stream(self, path1: str, path2: str | None, pair_end: bool,
                   fastq: bool, writer, progress=None) -> None:
        """Map one whole library (file or file pair), streaming SAM text to
        `writer`, four reader chunks at a time."""
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
