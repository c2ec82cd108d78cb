"""The comparison that decides `correct`: the streams that the timed path
downloaded, decoded, against the plain reference's seeds of the same reads.

The reference (`references/<name>.py`, named by the configuration) works
out its own suffix array from the genome's bases (cached in the genome's
directory, made by the first run that needs it) and takes nothing from the
port.  For every read of a checked group that the port did not flag, the
(rpos, length, text position) tuples must equal the reference's, in
emission order: any difference makes the read mismatched, and one
mismatched read makes the run not correct (the limit is 0).  A flagged read
(the funnel's hit budget or the stream's occurrence budget) carries no
seeds: it counts as failed, and its bases leave the rate.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import torch

from benchmark import genome as genome_mod
from benchmark import sa_search, yardstick

LIMIT_MISMATCHED = 0


def genome_codes(config: dict, cache: str) -> np.ndarray:
    """The genome's 2-bit codes, cached in its directory."""
    from benchmark.traffic import codes_of

    path = os.path.join(cache, "genome_codes.npy")
    if os.path.exists(path):
        return np.load(path)
    os.makedirs(cache, exist_ok=True)
    codes = codes_of(genome_mod.genome_bases(config))
    genome_mod.save_atomic(path, lambda f: np.save(f, codes))
    return codes


def reference_index(codes: np.ndarray, cache: str, dev, max_bases: int) -> sa_search.SuffixIndex:
    """The reference's suffix index of the genome's text; its suffix array is
    made on `dev` and cached the first time."""
    text = sa_search.text_of(codes)
    path = os.path.join(cache, "ref_sa.npy")
    if os.path.exists(path):
        sa = np.load(path)
    else:
        sa = sa_search.suffix_array(torch.from_numpy(text).to(dev)).cpu().numpy().astype(np.int32)
        genome_mod.save_atomic(path, lambda f: np.save(f, sa))
    return sa_search.SuffixIndex(text, sa, dev, max_bases)


def reference_seeds(config: dict, index, reads: np.ndarray, rlens: np.ndarray, dev):
    """The configuration's reference on one group -> (counts, rpos, slen,
    gpos as numpy, searches as device tensors, the reads on the device)."""
    ref = importlib.import_module(f"benchmark.references.{config['reference']}")
    r = torch.from_numpy(reads).to(dev)
    rl = torch.from_numpy(rlens).to(dev)
    cnt, rp, sl, gp, searches = ref.seeds(index, r, rl, config)
    return (cnt.cpu().numpy(), rp.cpu().numpy(), sl.cpu().numpy(), gp.cpu().numpy(), searches,
            r, rl)


def mismatched(ok, tot, offs, rpos, slen, gpos, r_cnt, r_rp, r_sl, r_gp) -> np.ndarray:
    """Per read: True where the read is not flagged (ok) and its tuples
    differ from the reference's."""
    B = len(ok)
    r_offs = np.zeros(B + 1, np.int64)
    np.cumsum(r_cnt, out=r_offs[1:])
    bad = ok & (tot.astype(np.int64) != r_cnt)
    same = np.nonzero(ok & ~bad)[0]
    n = r_cnt[same]
    if n.sum():
        rep = np.repeat(np.arange(len(same)), n)
        j = np.arange(rep.size) - np.repeat(np.cumsum(n) - n, n)
        pi = offs[same][rep] + j
        ri = r_offs[same][rep] + j
        inside = (pi >= 0) & (pi < len(rpos))  # a garbled count can point past the stream
        pi = np.where(inside, pi, 0)
        diff = ~inside | ((rpos[pi] != r_rp[ri]) | (slen[pi] != r_sl[ri])
                          | (gpos[pi].astype(np.int64) != r_gp[ri]))
        per = np.zeros(len(same), np.int64)
        np.add.at(per, rep, diff)
        bad[same[per > 0]] = True
    return bad


def decode(stream, B: int, budget: int, pack16: bool):
    """A downloaded stream, decoded by the port's own host decoder (the one
    the mapper's finalize uses) -> (ok, tot, offs, rpos, slen, gpos)."""
    from kart_tpu_torch.ops.pack import unpack_stream
    from kart_tpu_torch.ops.resolve import decode_resolved_counts

    arrs = tuple(t.numpy() for t in stream) if isinstance(stream, tuple) else stream.numpy()
    cnts, meta, gpos = unpack_stream(arrs, B, budget, pack16)
    ok, tot, offs = decode_resolved_counts(cnts)
    rpos = (meta & 0xFFFF).astype(np.int64)
    slen = ((meta >> 16) & 0xFFFF).astype(np.int64)
    return ok, tot, offs, rpos, slen, gpos


def group_check(config, index, reads, rlens, streams, B, budget, pack16, dev) -> dict:
    """One checked group: every stream the window left for it against the
    reference -> counts, the mismatched reads' ids and the group's work."""
    r_cnt, r_rp, r_sl, r_gp, searches, rd, rl = reference_seeds(config, index, reads, rlens, dev)
    bad = np.zeros(B, bool)
    flagged = 0
    for s in streams:
        ok, tot, offs, rpos, slen, gpos = decode(s, B, budget, pack16)
        bad |= mismatched(ok, tot, offs, rpos, slen, gpos, r_cnt, r_rp, r_sl, r_gp)
        flagged = max(flagged, int((~ok).sum()))
    work = yardstick.group_work(rd, rl, searches, index.sa, int(config["stream_bits"]))
    return dict(mismatched=int(bad.sum()), first_bad=np.nonzero(bad)[0][:5].tolist(),
                occurrences=int(r_cnt.sum()),
                flagged=flagged, streams=len(streams), work=work)
