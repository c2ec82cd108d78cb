"""Runtime genome index: host-side tables + device-layout arrays.

Mirrors the reference's index load + reference restoration (reference:
src/bwt_index.cpp:148-259): loads .bwt/.sa/.ann/.pac, rebuilds chromosome
tables including the ChrLocMap boundary map, and decodes the packed genome
into the fwd+revcomp ASCII text used by the conquer step.

The device layout de-interleaves the .bwt payload into separate Occ-checkpoint
and BWT-word arrays so device kernels gather rows instead of strided mixed
records.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from .format import CODE_TO_ASCII, RawIndex, load_raw_index, unpack_2bit


@dataclass
class GenomeIndex:
    raw: RawIndex

    @property
    def primary(self) -> int:
        return self.raw.primary

    @property
    def seq_len(self) -> int:
        return self.raw.seq_len

    @property
    def genome_size(self) -> int:
        return self.raw.l_pac

    @property
    def two_genome_size(self) -> int:
        return self.raw.seq_len

    @property
    def L2(self) -> np.ndarray:
        return self.raw.L2

    @property
    def n_chrom(self) -> int:
        return len(self.raw.chrom_names)

    @cached_property
    def chrom_fwd_loc(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.raw.chrom_lens)[:-1]])

    @cached_property
    def chrom_rev_loc(self) -> np.ndarray:
        ends = np.cumsum(self.raw.chrom_lens)
        return self.two_genome_size - ends

    @cached_property
    def chr_map(self) -> tuple[np.ndarray, np.ndarray]:
        """Sorted (keys, chrom_idx) equivalent of the reference ChrLocMap:
        keys are the last genome position of each chromosome on the forward
        and reverse halves of the 2x genome (bwt_index.cpp:250-251)."""
        keys, vals = [], []
        lens = self.raw.chrom_lens
        for i in range(self.n_chrom):
            keys.append(self.chrom_fwd_loc[i] + lens[i] - 1)
            vals.append(i)
            keys.append(self.chrom_rev_loc[i] + lens[i] - 1)
            vals.append(i)
        keys = np.array(keys, dtype=np.int64)
        vals = np.array(vals, dtype=np.int64)
        order = np.argsort(keys)
        return keys[order], vals[order]

    def chr_lower_bound(self, g_pos) -> np.ndarray:
        """Index of the first boundary key >= g_pos (std::map::lower_bound).
        Returns len(keys) when off the end."""
        keys, _ = self.chr_map
        return np.searchsorted(keys, g_pos, side="left")

    @cached_property
    def ref_codes(self) -> np.ndarray:
        """2-bit codes of the full fwd+revcomp text (length 2L)."""
        fwd = unpack_2bit(self.raw.pac, self.genome_size)
        return np.concatenate([fwd, (3 - fwd)[::-1]])

    @cached_property
    def sa_full(self) -> np.ndarray:
        """Full suffix array over the 2L text (+ sentinel row): sa_full[k] ==
        bwt_sa(k) for all rows k >= 1.  Loaded from the .saf sidecar when
        present (written by our indexer) or recomputed with SA-IS from the
        packed genome for reference-built indexes."""
        import os

        path = self.raw.prefix + ".saf"
        if self.raw.prefix and os.path.exists(path):
            with open(path, "rb") as f:
                return np.load(f)
        from ..native import suffix_array

        dtype = np.int32 if self.seq_len < 2**31 else np.int64
        return suffix_array(self.ref_codes + 1).astype(dtype)

    @cached_property
    def ref_seq(self) -> np.ndarray:
        """ASCII uint8 of the full fwd+revcomp text (the RefSequence of the
        reference, bwt_index.cpp:194-228). No Ns: pac already randomized."""
        return CODE_TO_ASCII[self.ref_codes]

    # ---- device-layout arrays ---------------------------------------------

    @property
    def index_dtype(self):
        """int32 for genomes under 2^31 text bases, int64 above (human
        scale).  The reference index is 64-bit throughout
        (src/BWT_Index/bwt.h:41 bwtint_t); we pay the wide type only when
        the genome needs it."""
        return np.int32 if self.seq_len < 2**31 else np.int64

    @cached_property
    def device_arrays(self) -> dict:
        """Arrays shipped to the device for the FM-search kernels.

        occ_cp   (n_blocks, 4) i32/i64 Occ counts at each 128-base checkpoint
        bwt_words(n_blocks, 8) uint32  2-bit BWT codes, 16 bases/word
        sa_samples (n_sa,)     i32/i64 sampled SA (sa[0] == -1)
        L2       (5,)          i32/i64 cumulative char counts
        params: primary, seq_len scalars of the same index dtype

        The index dtype is int32 below 2^31 text bases and int64 at human
        scale (torch has int64, so nothing is to be enabled for the wide
        arrays).  The full SA (17+ GB at human scale) is NOT
        part of this dict — device users fetch `sa_full` separately when
        they can afford it (FMIndexTensors.from_genome_index)."""
        r = self.raw
        idt = self.index_dtype
        return dict(
            occ_cp=r.occ_cp.astype(idt, copy=False),
            bwt_words=r.bwt_words,
            sa_samples=r.sa_samples.astype(idt, copy=False),
            L2=r.L2.astype(idt, copy=False),
            primary=idt(r.primary),
            seq_len=idt(r.seq_len),
            sa_intv=np.int32(r.sa_intv),
        )


def load_index(prefix: str) -> GenomeIndex:
    return GenomeIndex(load_raw_index(prefix))
