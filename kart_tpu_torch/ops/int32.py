"""The int32 positions of the python backend's device clustering and mating.

kart_tpu writes every position of those two stages into int32 arrays, and
the port keeps them so: the mapper's two hooks refuse an index of 2**31 text
bases or more (kart_tpu would overflow or wrap there), and the two ops
modules convert their host values with a check.
"""

from __future__ import annotations

import numpy as np

INT32_LIMIT = 2**31


def check_int32_index(gidx, what: str) -> None:
    """Refuse an index whose text positions do not fit int32 (two_genome_size
    at 2**31 or more): the device clustering and mating take int32."""
    if gidx.two_genome_size >= INT32_LIMIT:
        raise ValueError(
            f"{what}: positions are int32, so the index must have fewer than 2**31 text bases;"
            f" this one has {gidx.two_genome_size}")


def int32_array(values, what: str) -> np.ndarray:
    """A list of Python ints as an int32 array; ValueError if one does not fit."""
    a = np.asarray(values, dtype=np.int64)
    if a.size and (a.min() < -INT32_LIMIT or a.max() >= INT32_LIMIT):
        raise ValueError(f"{what}: a value does not fit int32 (the device stages take int32)")
    return a.astype(np.int32)
