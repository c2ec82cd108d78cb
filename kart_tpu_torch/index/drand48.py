"""Bit-exact replica of glibc's lrand48() 48-bit LCG.

The reference indexer replaces ambiguous (N) bases with random bases drawn
from lrand48()&3 after srand48(11) (reference: src/BWT_Index/bntseq.c:144,
173-174).  Reproducing the generator exactly is required for byte-identical
.pac/.bwt artifacts and therefore bit-identical SAM output.

lrand48: X_{i+1} = (a*X_i + c) mod 2^48, a=0x5DEECE66D, c=0xB,
         srand48(seed) sets X = (seed << 16) | 0x330E,
         each call returns X_{i+1} >> 17 (31 bits).
"""

from __future__ import annotations

import numpy as np

_A = 0x5DEECE66D
_C = 0xB
_MASK48 = (1 << 48) - 1


class Drand48:
    def __init__(self, seed: int = 11):
        self.x = ((seed << 16) | 0x330E) & _MASK48

    def lrand48(self) -> int:
        self.x = (_A * self.x + _C) & _MASK48
        return self.x >> 17

    def lrand48_array(self, n: int) -> np.ndarray:
        """Vectorized batch of n successive lrand48() values (int64)."""
        if n <= 0:
            return np.zeros(0, dtype=np.int64)
        # Jump-ahead coefficients: X_{i+j} = A_j * X_i + C_j (mod 2^48).
        chunk = min(n, 65536)
        a_j = np.empty(chunk + 1, dtype=object)
        c_j = np.empty(chunk + 1, dtype=object)
        a_j[0], c_j[0] = 1, 0
        for j in range(1, chunk + 1):
            a_j[j] = (a_j[j - 1] * _A) & _MASK48
            c_j[j] = (a_j[j - 1] * _C + c_j[j - 1]) & _MASK48
        out = np.empty(n, dtype=np.int64)
        pos = 0
        while pos < n:
            m = min(chunk, n - pos)
            xs = [(int(a_j[j]) * self.x + int(c_j[j])) & _MASK48 for j in range(1, m + 1)]
            out[pos : pos + m] = np.array([x >> 17 for x in xs], dtype=np.int64)
            self.x = xs[-1]
            pos += m
        return out
