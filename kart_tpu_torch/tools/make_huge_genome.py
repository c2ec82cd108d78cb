"""Generate the >2^31-text synthetic genome used by the i64 large-genome
golden test (tests/test_huge_genome.py): 1.1 Gbp over two chromosomes so the
2x (fwd+revcomp) BWT text is 2.2e9 > 2^31 bases, with dispersed repeat
families for realistic OCC pressure.  Deterministic (seeded).

The port's copy of the repository's `tools/make_huge_genome.py` (the same
bytes for the same seed):

    python -m kart_tpu_torch.tools.make_huge_genome tests/_work/huge/huge.fa
"""

import os
import sys

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
CHROM_LENS = [600_000_000, 500_000_000]


def write_genome(path: str, seed: int = 97) -> None:
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for ci, L in enumerate(CHROM_LENS):
            f.write(f">chr{ci + 1} huge synthetic {ci + 1}\n".encode())
            seq = rng.choice(_BASES, size=L)
            # dispersed 5 kb repeat family (20 copies, 1% divergence)
            src = rng.choice(_BASES, size=5000)
            for _ in range(20):
                frag = src.copy()
                n = rng.binomial(len(frag), 0.01)
                if n:
                    idx = rng.integers(0, len(frag), size=n)
                    frag[idx] = _BASES[rng.integers(0, 4, size=n)]
                p = int(rng.integers(0, L - len(frag)))
                seq[p : p + len(frag)] = frag
            # stream out in 70-col lines without a giant join
            width = 70
            CH = width * 2_000_000  # 140 MB of sequence per write
            for s0 in range(0, L, CH):
                part = seq[s0 : s0 + CH]
                n = len(part)
                rows = -(-n // width)
                buf = np.full((rows, width + 1), ord("\n"), dtype=np.uint8)
                pad = rows * width - n
                flat = np.concatenate([part, np.zeros(pad, np.uint8)]) if pad else part
                buf[:, :width] = flat.reshape(rows, width)
                data = buf.tobytes()
                if pad:
                    # drop padding zeros in the final row
                    last_row = buf[-1, : width - pad].tobytes() + b"\n"
                    data = buf[:-1].tobytes() + last_row
                f.write(data)
            del seq


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "huge.fa"
    write_genome(out)
    print(f"wrote {out}: {os.path.getsize(out)} bytes")
