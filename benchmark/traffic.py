"""The one general read generator: a traffic file's parameters -> a pool of
reads, made on the run's device, and the order a run deals its groups in.

The pool is the traffic's library, drawn from its own `library_seed`: every
`--seed` gets the same reads in the same groups, and the seed draws only the
order in which the window cycles through the groups (`group_order`).  So
every seed does the same work, and the share of reads that the program
flags, which varies from group to group by some tenfold, is the library's
whatever the length of a run.

Two kinds of read, each drawn vectorised in torch (no loop a base):

* `paired_end`: pairs of `read_len` bases off both ends of a fragment of
  insert ~ N(insert_mean, insert_sd) (at least two reads long), with
  `sub_rate` substitutions a base (a uniform base, as wgsim and simdata
  draw them) and, with probability `indel_rate` x insert, one deletion or
  insertion of 1-3 bases inside the fragment; read 2 is the reverse
  complement of the fragment's end.  simdata's recipe (bench.py's and the
  Kart README's wgsim set).
* `long`: reads of `min_len` to `max_len` bases read off the genome with
  simdata's PacBio error model: each step a substitution (err x
  sub_share), a deletion (err x del_share), an insertion (err x ins_share)
  or the base itself.

Reads come back as (n, l_max) int8 codes (A C G T = 0-3, pad 4) and (n,)
int32 lengths, on the host, in the order the mapper's reader would give
them (read 1, read 2 of each pair in turn).
"""

from __future__ import annotations

import numpy as np
import torch

PAIR_BLOCK = 1 << 17  # pairs made at a time


def codes_of(genome_ascii: np.ndarray) -> np.ndarray:
    """ASCII bases -> 2-bit codes (A C G T = 0 1 2 3)."""
    lut = np.full(256, 255, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    codes = lut[genome_ascii]
    if (codes > 3).any():
        raise ValueError("the genome holds a base other than A, C, G, T")
    return codes


def _uniform_int(n: int, hi: torch.Tensor, gen, dev) -> torch.Tensor:
    """n integers uniform in [0, hi) (hi a tensor of n, or a number)."""
    return (torch.rand(n, generator=gen, device=dev, dtype=torch.float64) * hi).long()


def paired_end(genome: torch.Tensor, n_pairs: int, p: dict, gen) -> torch.Tensor:
    """(2 n_pairs, read_len) int8 codes: read 1 and read 2 of each pair."""
    dev = genome.device
    R = int(p["read_len"])
    L = genome.shape[0]
    n = n_pairs
    ins = torch.normal(float(p["insert_mean"]), float(p["insert_sd"]), size=(n,), generator=gen,
                       device=dev).long().clamp(min=2 * R)
    pos = _uniform_int(n, (L - ins).double(), gen, dev)
    has = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) < (
        float(p["indel_rate"]) * ins.double())
    is_del = torch.rand(n, generator=gen, device=dev) < 0.5
    q = 10 + _uniform_int(n, (ins - 20).double(), gen, dev)
    ln = 1 + _uniform_int(n, 3.0, gen, dev)
    ins_bases = torch.randint(0, 4, (n, 3), generator=gen, device=dev, dtype=torch.uint8)
    d = (has & is_del)[:, None]
    a = (has & ~is_del)[:, None]
    q, ln = q[:, None], ln[:, None]
    frag_len = ins[:, None] - torch.where(d, ln, 0) + torch.where(a, ln, 0)
    j = torch.arange(R, device=dev)[None, :]
    reads = []
    for k in (j.expand(n, R), frag_len - R + j):  # read 1's and read 2's fragment offsets
        off = torch.where(d & (k >= q), k + ln, k)
        off = torch.where(a & (k >= q + ln), k - ln, off)
        inserted = a & (k >= q) & (k < q + ln)
        b = genome[pos[:, None] + off]
        b = torch.where(inserted, ins_bases.gather(1, (k - q).clamp(0, 2)), b)
        sub = torch.rand((n, R), generator=gen, device=dev) < float(p["sub_rate"])
        b = torch.where(sub, torch.randint(0, 4, (n, R), generator=gen, device=dev,
                                           dtype=torch.uint8), b)
        reads.append(b)
    r2 = 3 - reads[1].flip(1)
    return torch.stack([reads[0], r2], dim=1).reshape(2 * n, R).to(torch.int8)


def long_reads(genome: torch.Tensor, n: int, p: dict, l_max: int, gen, block: int = 1024):
    """(n, l_max) int8 codes (pad 4) and (n,) int32 lengths of noisy long
    reads; a read ends early where it runs out of its source span."""
    dev = genome.device
    L = genome.shape[0]
    err = float(p["err"])
    t_sub = err * float(p["sub_share"])
    t_del = t_sub + err * float(p["del_share"])
    t_ins = t_del + err * float(p["ins_share"])
    rl_all = torch.randint(int(p["min_len"]), int(p["max_len"]) + 1, (n,), generator=gen,
                           device=dev)
    out = torch.full((n, l_max), 4, dtype=torch.int8, device=dev)
    rlens = torch.empty(n, dtype=torch.int32, device=dev)
    steps = int(int(p["max_len"]) * float(p["steps_per_base"]))
    for b0 in range(0, n, block):
        rl = rl_all[b0 : b0 + block]
        m = rl.shape[0]
        pos = _uniform_int(m, (L - 2 * rl).double(), gen, dev)
        span = (rl.double() * float(p["span"])).long()
        r = torch.rand((m, steps), generator=gen, device=dev)
        prod = ~((r >= t_sub) & (r < t_del))  # every step but a deletion writes a base
        cons = ~((r >= t_del) & (r < t_ins))  # every step but an insertion reads one
        j = torch.cumsum(cons, 1, dtype=torch.int32) - cons.int()
        o = torch.cumsum(prod, 1, dtype=torch.int32) - prod.int()
        emit = prod & (j < span[:, None]) & (o < rl[:, None])
        src = genome[pos[:, None] + j.long().minimum(span[:, None] - 1)]
        shift = torch.randint(1, 4, (m, steps), generator=gen, device=dev, dtype=torch.uint8)
        rand_base = torch.randint(0, 4, (m, steps), generator=gen, device=dev, dtype=torch.uint8)
        base = torch.where(r < t_sub, (src + shift) % 4, src)
        base = torch.where(cons, base, rand_base)
        rows = torch.arange(m, device=dev)[:, None].expand(m, steps)
        blk = torch.full((m, l_max), 4, dtype=torch.int8, device=dev)
        blk[rows[emit], o[emit].long()] = base[emit].to(torch.int8)
        out[b0 : b0 + m] = blk
        rlens[b0 : b0 + m] = emit.sum(1, dtype=torch.int32)
    return out, rlens


def group_order(p: dict, seed: int) -> list:
    """The pool's groups in the order a run with `seed` cycles through them."""
    rng = np.random.default_rng([int(seed), 1])
    return [int(g) for g in rng.permutation(int(p["pool_groups"]))]


def make_pool(genome_codes: np.ndarray, p: dict, dev) -> tuple[np.ndarray, np.ndarray]:
    """The traffic's whole pool, pool_groups x group_reads reads, from its
    `library_seed` -> ((N, l_max) int8 codes padded 4, (N,) int32 lengths)
    on the host."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(p["library_seed"]))
    genome = torch.from_numpy(genome_codes).to(dev)
    n = int(p["pool_groups"]) * int(p["group_reads"])
    l_max = int(p["l_max"])
    if p["kind"] == "paired_end":
        R = int(p["read_len"])
        if n % 2 or R > l_max:
            raise ValueError("paired_end needs an even pool and read_len <= l_max")
        reads = np.full((n, l_max), 4, dtype=np.int8)
        for b0 in range(0, n, 2 * PAIR_BLOCK):
            m = min(2 * PAIR_BLOCK, n - b0)
            reads[b0 : b0 + m, :R] = paired_end(genome, m // 2, p, gen).cpu().numpy()
        return reads, np.full(n, R, dtype=np.int32)
    elif p["kind"] == "long":
        if int(p["max_len"]) > l_max:
            raise ValueError("long reads need max_len <= l_max")
        reads, rlens = long_reads(genome, n, p, l_max, gen)
    else:
        raise ValueError(f"unknown traffic kind {p['kind']!r}")
    return reads.cpu().numpy(), rlens.cpu().numpy()
