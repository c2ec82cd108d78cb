"""Entry points of the port: a single-device seeding step and the
multi-device dry run.

Counterpart of the repository's root `__graft_entry__.py` (kart_tpu's, which
stays as it is), on the port's own modules: `_tiny_index()` builds the same
in-memory 40,000-base index from seed 123, `entry()` returns the FastMode
seed scan plus the full-SA gather with example reads, and
`dryrun_multichip(n)` runs the whole front half (parallel/dp.py::
make_full_mapping_step) over three meshes and asserts their outputs equal.
Both run on the card unless given the CPU: `entry("cpu")`,
`dryrun_multichip(8, devices=[torch.device("cpu")] * 8)`.  On one card,
`devices=[torch.device("cuda", 0)] * n` puts every mesh position there.

    python -m kart_tpu_torch.graft_entry    # on the card: entry() once, then the dry run
"""

from __future__ import annotations

import numpy as np
import torch


def _tiny_index():
    """Deterministic in-memory genome index (no disk)."""
    from .index.format import RawIndex, interleave_bwt, pack_2bit
    from .index.loader import GenomeIndex
    from .native import suffix_array

    rng = np.random.default_rng(123)
    fwd = rng.integers(0, 4, size=20000).astype(np.uint8)
    text = np.concatenate([fwd, (3 - fwd)[::-1]])
    seq_len = len(text)
    sa_full = suffix_array(text + 1)
    primary = int(np.nonzero(sa_full == 0)[0][0])
    bwt_all = text[(sa_full - 1) % seq_len]
    mask = np.ones(seq_len + 1, dtype=bool)
    mask[primary] = False
    bwt_codes = bwt_all[mask]
    counts = np.bincount(text, minlength=4).astype(np.int64)
    l2 = np.zeros(5, dtype=np.int64)
    l2[1:] = np.cumsum(counts)
    occ_cp, words, _ = interleave_bwt(bwt_codes)
    n_sa = seq_len // 32 + 1
    sa_samples = sa_full[::32][:n_sa].copy()
    sa_samples[0] = -1
    raw = RawIndex(
        primary=primary,
        L2=l2,
        seq_len=seq_len,
        occ_cp=occ_cp,
        bwt_words=words,
        sa_intv=32,
        sa_samples=sa_samples,
        l_pac=len(fwd),
        pac=pack_2bit(fwd),
        chrom_names=["tiny"],
        chrom_lens=np.array([len(fwd)], dtype=np.int64),
        ann_offsets=np.array([0], dtype=np.int64),
    )
    gidx = GenomeIndex(raw)
    gidx.__dict__["sa_full"] = sa_full.astype(np.int32)  # prime cached_property
    return gidx


def _example_reads(gidx, b, rlen, seed=0):
    rng = np.random.default_rng(seed)
    codes = gidx.ref_codes
    pos = rng.integers(0, gidx.two_genome_size - rlen, size=b)
    reads = np.stack([codes[p : p + rlen] for p in pos]).astype(np.int32)
    rlens = np.full(b, rlen, dtype=np.int32)
    return reads, rlens


def _card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass the CPU as the device to run the"
                           " plain versions there")
    return torch.device("cuda", 0)


def entry(device=None):
    """(fn, example_args): the flagship step, the batched FastMode seed scan
    + full-SA occurrence resolution, on `device` (the card by default), with
    64 example reads of 100 bases there."""
    from .ops.fm_search import FMIndexTensors, seed_scan

    dev = _card() if device is None else torch.device(device)
    gidx = _tiny_index()
    fm = FMIndexTensors.from_genome_index(gidx, dev, with_full_sa=True)
    sa_full = fm.sa_full.to(dev)
    rlen = 100
    min_seed = 13
    max_seeds = rlen // (min_seed + 1) + 1

    def fn(reads, rlens):
        packed = seed_scan(fm, reads, rlens, min_seed, max_seeds=max_seeds, l_max=rlen)
        # resolve every candidate occurrence start (gather fast path)
        k0 = packed[:, 1 + 2 * max_seeds : 1 + 3 * max_seeds]
        locs = sa_full[k0.long()]
        return packed, locs

    reads, rlens = _example_reads(gidx, 64, rlen)
    return fn, (torch.from_numpy(reads).to(dev), torch.from_numpy(rlens).to(dev))


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the whole device mapping front half (FastMode seeding ->
    occurrence expansion and SA resolution -> PosDiff sort -> candidate
    clustering -> paired-end mating) for one step on tiny shapes over three
    meshes of n_devices positions (`devices`, or cuda:0 .. cuda:n-1):

    1. a single-device reference run;
    2. n x 1 data-parallel reads with a replicated index;
    3. (n/2) x 2 data x idx with the index block-sharded along idx in the
       sampled SA mode: no full SA anywhere, rows resolved by the sharded
       inverse-Psi walk (when n is even).

    Asserts no read is flagged (an occurrence budget overrun) and every
    stage's output (each read's resolved occurrences, cluster ids,
    acceptance and scores, mate links) equal across the meshes."""
    from .parallel.dp import make_data_mesh, make_full_mapping_step, per_read_entries

    gidx = _tiny_index()
    rlen = 32
    min_seed = 13
    max_seeds = rlen // (min_seed + 1) + 1
    B = 4 * n_devices  # 2 PE pairs per data shard
    reads, rlens = _example_reads(gidx, B, rlen, seed=1)

    def run(mesh, idx_axis, n_data, sa_mode="full"):
        step, place = make_full_mapping_step(
            mesh, gidx, idx_axis=idx_axis,
            min_seed_len=min_seed, max_seeds=max_seeds, l_max=rlen,
            sa_mode=sa_mode,
        )
        stream, cl, pe = step(*place(reads, rlens))
        # a flagged read overran its block's budget and would be re-seeded
        # by a caller: at these shapes it is a failure
        n_flagged = int((stream[0] < 0).sum())
        assert n_flagged == 0, f"occ_budget overflow flagged {n_flagged} reads in dryrun"
        # per read: each block compacts its own stream, so the flat layout
        # depends on the mesh, each read's content does not
        per_read = [x.cpu().numpy() for x in per_read_entries(stream, n_data)]
        return per_read, [x.cpu().numpy() for x in (*cl, *pe)]

    ref_stream, ref_rest = run(make_data_mesh(1, devices=devices), None, 1)

    dp_stream, dp_rest = run(make_data_mesh(n_devices, devices=devices), None, n_devices)
    for a, b in zip(dp_stream, ref_stream):
        np.testing.assert_array_equal(a, b, err_msg="DP resolved stream != single-device")
    for a, b in zip(dp_rest, ref_rest):
        np.testing.assert_array_equal(a, b)

    n_idx = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    if n_idx > 1:
        mesh2 = make_data_mesh(n_devices // n_idx, n_idx, devices=devices)
        sh_stream, sh_rest = run(mesh2, "idx", n_devices // n_idx, sa_mode="sampled")
        for a, b in zip(sh_stream, ref_stream):
            np.testing.assert_array_equal(a, b, err_msg="sharded-index stream != single-device")
        for a, b in zip(sh_rest, ref_rest):
            np.testing.assert_array_equal(a, b)

    n_occ = int(ref_stream[0].sum())
    print(
        f"[dryrun_multichip] ok: {n_devices} devices, batch {B}, "
        f"{n_occ} resolved occurrences; seed->resolve->cluster->pair equal "
        f"across single-device, {n_devices}x1 DP"
        + (f" and {n_devices // n_idx}x{n_idx} sharded-index meshes" if n_idx > 1 else "")
    )


if __name__ == "__main__":
    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    print("entry() runs")
    dryrun_multichip(torch.cuda.device_count())
