"""The port's paired-end mating (`kart_tpu_torch/ops/pairing.py`) against
kart_tpu's (`kart_tpu/ops/pairing.py`) on the CPU: the plain version array
for array on batches made with numpy from a seed, and `pair_chunk_on_device`
on Candidate lists (paired_idx and flags), also against the host mating
(`pipeline/pairing.check_paired_candidates`).  Every value is an integer, so
every comparison is exact.  `tests/test_torch_host_shim.py` runs the same
batches through `csrc/pairing.cu`."""

import copy

import numpy as np
import pytest
import torch

from kart_tpu.ops import pairing as jpa
from kart_tpu.pipeline.candidates import Candidate as JaxCandidate
from kart_tpu_torch.ops import pairing as tpa
from kart_tpu_torch.pipeline.candidates import Candidate
from kart_tpu_torch.pipeline.pairing import check_paired_candidates

torch.set_num_threads(1)
EST = 1500


def slots(lists, width):
    """(scores, posdiffs) (P, width) int32 of (score, posdiff) lists, 0 past each."""
    s = np.zeros((len(lists), width), np.int32)
    d = np.zeros((len(lists), width), np.int32)
    for p, row in enumerate(lists):
        for i, (a, b) in enumerate(row):
            s[p, i], d[p, i] = a, b
    return s, d


def pair_case(rows1, rows2, est=EST):
    c1 = max(1, max(len(r) for r in rows1))
    c2 = max(1, max(len(r) for r in rows2))
    return (*slots(rows1, c1), *slots(rows2, c2), est)


def pairing_cases() -> dict:
    """name -> (score1, pd1, score2, pd2, est)."""
    rng = np.random.default_rng(99)
    cases = {}
    # random widths with zero-score slots; few distinct scores, so ties and steals are common
    P, C1, C2 = 300, 9, 11
    s1 = rng.integers(0, 6, (P, C1)).astype(np.int32)
    s2 = rng.integers(0, 6, (P, C2)).astype(np.int32)
    d1 = rng.integers(0, 3000, (P, C1)).astype(np.int32)
    d2 = (d1[:, :1] + rng.integers(-200, 2000, (P, C2))).astype(np.int32)
    cases["random"] = (s1, d1, s2, d2, EST)
    # C1 and C2 above 32: the lanes stride over C2
    P, C1, C2 = 40, 45, 70
    cases["wide"] = (rng.integers(0, 4, (P, C1)).astype(np.int32),
                     rng.integers(0, 400, (P, C1)).astype(np.int32),
                     rng.integers(0, 4, (P, C2)).astype(np.int32),
                     rng.integers(0, 500, (P, C2)).astype(np.int32), 100)
    # kart_tpu's tie and steal cases, a steal that a third candidate cannot
    # undo, and a steal by the second of two
    cases["tie_and_steal"] = pair_case(
        [[(10, 100), (20, 100)], [(10, 100)], [(10, 100), (30, 100), (20, 100)],
         [(5, 100), (9, 100)], [(20, 100), (10, 100)]],
        [[(30, 200)], [(30, 200), (30, 300)], [(7, 200), (7, 300), (9, 400)],
         [(30, 200), (20, 300)], [(30, 200)]])
    # pd2 - pd1 of 0 (taken), est - 1 (taken) and est (not), and pd2 < pd1
    cases["distance_edges"] = pair_case(
        [[(10, 500)], [(10, 500)], [(10, 500)], [(10, 500)]],
        [[(30, 500)], [(30, 500 + EST - 1)], [(30, 500 + EST)], [(30, 499)]])
    # no candidates at all, and all-zero scores
    cases["empty"] = pair_case([[], [(0, 10)]], [[(5, 20)], []])
    return cases


def run_both(args):
    s1, d1, s2, d2, est = args
    want = jpa.pair_candidates(s1, d1, s2, d2, np.int32(est))
    got = tpa.pair_candidates(*(torch.from_numpy(a) for a in (s1, d1, s2, d2)), est)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


CASES = ["random", "wide", "tie_and_steal", "distance_edges", "empty"]


@pytest.mark.parametrize("name", CASES)
def test_pair_plain_matches_jax(name):
    want, got = run_both(pairing_cases()[name])
    for w, g, what in zip(want, got, ("paired1", "paired2", "pairing")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        np.testing.assert_array_equal(g, w, err_msg=what)
    p1, p2, flag = want
    if name == "random":
        assert flag.mean() > 0.5 and (p1 < 0).any()
    if name == "tie_and_steal":
        # the higher score steals; a tie gives none; a lower score does not steal
        assert p1[:, :2].tolist() == [[-1, 0], [-1, -1], [-1, 2], [-1, 0], [0, -1]]
        assert p1[2, 2] == -1 and flag.tolist() == [True, False, True, True, True]
    if name == "distance_edges":
        assert p1[:, 0].tolist() == [0, 0, -1, -1]


def cands(rng, n, cls):
    return [cls(score=int(rng.integers(0, 40)), posdiff=int(rng.integers(0, 3000)))
            for _ in range(n)]


def test_pair_chunk_on_device_matches_jax():
    """paired_idx and the flags of the port's wrapper equal kart_tpu's and
    the host mating's, on 300 random pairs (empty lists among them)."""
    rng = np.random.default_rng(23)
    pairs, jpairs = [], []
    for _ in range(300):
        n1, n2 = int(rng.integers(0, 8)), int(rng.integers(0, 8))
        a, b = cands(rng, n1, Candidate), cands(rng, n2, Candidate)
        pairs.append((a, b))
        jpairs.append(([JaxCandidate(score=c.score, posdiff=c.posdiff) for c in a],
                       [JaxCandidate(score=c.score, posdiff=c.posdiff) for c in b]))
    host = copy.deepcopy(pairs)
    got = tpa.pair_chunk_on_device(EST, pairs, device="cpu")
    want = jpa.pair_chunk_on_device(EST, jpairs)
    assert got == want == [check_paired_candidates(EST, a, b) for a, b in host]
    assert sum(got) > 100
    for (a, b), (ja, jb), (ha, hb) in zip(pairs, jpairs, host):
        assert [c.paired_idx for c in a] == [c.paired_idx for c in ja] == [c.paired_idx for c in ha]
        assert [c.paired_idx for c in b] == [c.paired_idx for c in jb] == [c.paired_idx for c in hb]
    assert tpa.pair_chunk_on_device(EST, [], device="cpu") == []


def test_pair_chunk_on_device_refuses_positions_past_int32():
    a = [Candidate(score=10, posdiff=2**31)]
    with pytest.raises(ValueError, match="int32"):
        tpa.pair_chunk_on_device(EST, [(a, [Candidate(score=5, posdiff=0)])], device="cpu")
