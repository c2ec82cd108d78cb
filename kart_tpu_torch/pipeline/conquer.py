"""Conquer step of the port: kart_tpu's Conquer with counted memo misses.

The chunk mapper (`TorchKartMapper._batch_nw`) runs every NW fragment of a
chunk as one device batch and primes `nw_memo`; the report pass then reads
its alignments from the memo.  In kart_tpu a miss falls silently to the host
DP, which would hide the device kernel.  Here every NW that the report pass
answers without the memo is counted in `nw_memo_misses` (it still runs the
host DP, so the alignment is right either way).

`nw_alignment` is that host DP, kart_tpu's, used as it is: the reference of
the NW planes' backtrace, and the aligner of fragments longer than the
largest NW tile.
"""

from __future__ import annotations

from kart_tpu.pipeline.conquer import Conquer as _Conquer
from kart_tpu.pipeline.conquer import nw_alignment

__all__ = ["Conquer", "nw_alignment"]


class Conquer(_Conquer):
    def __init__(self, ref_seq, pacbio: bool, max_gaps: int):
        super().__init__(ref_seq, pacbio, max_gaps)
        self.nw_memo_misses = 0

    def _nw(self, s1: bytes, s2: bytes) -> tuple[bytes, bytes]:
        if self.collecting is None and (self.nw_memo is None or (s1, s2) not in self.nw_memo):
            self.nw_memo_misses += 1
        return super()._nw(s1, s2)
