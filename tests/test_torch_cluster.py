"""The port's seed clustering (`kart_tpu_torch/ops/cluster.py`) against
kart_tpu's (`kart_tpu/ops/cluster.py`) on the CPU: the plain version array
for array on batches made with numpy from a seed, and
`cluster_batch_to_candidates` Candidate for Candidate.  Every value is an
integer, so every comparison is exact.  `tests/test_torch_host_shim.py`
runs the same batches through `csrc/cluster.cu`."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kart_tpu.index import load_index as jax_load
from kart_tpu.ops import cluster as jcl
from kart_tpu_torch.index import build_index, load_index
from kart_tpu_torch.ops import cluster as tcl
from kart_tpu_torch.ops import int32 as i32
from kart_tpu_torch.pipeline.candidates import Seed, gen_candidates_illumina

from conftest import make_genome
from test_cluster_kernel import _random_seed_lists

torch.set_num_threads(1)
MAX_GAPS = 5


@pytest.fixture(scope="module")
def genome(workdir):
    return three_chromosomes(workdir)


def three_chromosomes(workdir):
    """Three chromosomes (6 keys); the port's index loaded by both packages."""
    d = workdir / "torch_cluster"
    d.mkdir(exist_ok=True)
    fa = d / "g.fa"
    fa.write_text(make_genome(np.random.default_rng(77), [3000, 5000, 2000]))
    build_index(str(fa), str(d / "idx"), verbose=False)
    return load_index(str(d / "idx")), jax_load(str(d / "idx"))


def to_arrays(lists, rlens):
    """Seed lists -> (pd, gp, ln, n_seeds, thr0), as kart_tpu's wrapper lays them out."""
    B = len(lists)
    S = max(1, max(len(s) for s in lists))
    pd = np.full((B, S), tcl._BIG, np.int32)
    gp = np.zeros((B, S), np.int32)
    ln = np.zeros((B, S), np.int32)
    n = np.array([len(s) for s in lists], np.int32)
    for b, seeds in enumerate(lists):
        for t, s in enumerate(seeds):
            pd[b, t], gp[b, t], ln[b, t] = s.posdiff, s.gpos, s.rlen
    thr0 = np.minimum((np.asarray(rlens) * 0.2).astype(np.int32), 50)
    return pd, gp, ln, n, thr0


def seeds_at(rows):
    """Seed lists from (rpos, gpos, len) triples, posdiff = gpos - rpos, in the given order."""
    return [[Seed(True, r, g, ln, ln, g - r) for r, g, ln in row] for row in rows]


def cluster_cases(keys: np.ndarray, two_genome: int) -> dict:
    """name -> (chr_keys, pd, gp, ln, n_seeds, thr0), int32 arrays."""
    rng = np.random.default_rng(2024)
    fake = types.SimpleNamespace(two_genome_size=two_genome)
    cases = {}
    lists = _random_seed_lists(fake, rng, 200, 120)
    cases["random_200"] = to_arrays(lists, [120] * 200)
    # up to 90 seeds a read in tight posdiff runs: the kernel's 32-slot chunks
    wide = []
    for _ in range(40):
        k, seeds, g = int(rng.integers(0, 91)), [], int(rng.integers(0, two_genome - 5000))
        for _ in range(k):
            g += int(rng.integers(0, 2 * MAX_GAPS + 3)) if rng.random() < 0.8 else 700
            r = int(rng.integers(0, 100))
            g = min(g, two_genome - 20)
            seeds.append(Seed(True, r, g, 13, 13, g - r))
        seeds.sort(key=lambda s: (s.posdiff, s.rpos))
        wide.append(seeds)
    wide += seeds_at([[(t, 5000 + t, 13) for t in range(40)]] * 2)  # one posdiff
    pd, gp, ln, n, thr0 = to_arrays(wide, rng.integers(20, 400, 42))
    # out of order: negative posdiffs anywhere, also at the end of a 32-slot
    # chunk (the one-posdiff reads: a chunk's last valid seed is not its last slot)
    neg = rng.random(pd.shape) < 0.15
    neg[::3, 28:32] = True
    neg[-2:] = False
    neg[-2:, 30:32] = True
    pd[neg] = -5
    cases["wide_chunks"] = (pd, gp, ln, n, thr0)
    cases["no_seeds"] = to_arrays([[] for _ in range(5)], [100] * 5)
    # negative posdiffs: leading (sorted, as the seeder gives them) and inside a row
    neg = seeds_at([[(50, 10, 20), (40, 30, 15), (5, 900, 30), (6, 902, 25)],
                    [(3, 1, 14), (60, 40, 20)],
                    [(0, 500, 20), (60, 40, 20), (1, 503, 20), (2, 504, 30)],
                    [(30, 29, 20), (5, 5, 20), (6, 7, 20)]])  # posdiff -1, 0, 1
    cases["negative_posdiffs"] = to_arrays(neg, [100] * 4)
    # a seed on the key, one past it and one before it, for every key (the
    # strand boundary is the last forward chromosome's key)
    rows = []
    for k in keys.tolist():
        for first, second in ((k - 1, k), (k, k + 1), (k - 3, k + 2), (k + 1, k + 2)):
            if 0 <= first and second < two_genome:
                rows.append([(10, first, 20), (10, second, 20)])
    cases["chromosome_keys"] = to_arrays(seeds_at(rows), [100] * len(rows))
    # posdiff steps of exactly max_gaps, and max_gaps + 1
    rows = [[(0, 1000, 20), (0, 1000 + MAX_GAPS, 20), (0, 1000 + 2 * MAX_GAPS + 1, 20)],
            [(0, 2000, 30), (0, 2000 + MAX_GAPS + 1, 30), (0, 2000 + 2 * MAX_GAPS + 1, 30)]]
    cases["gap_edges"] = to_arrays(seeds_at(rows), [150] * 2)
    cases["one_slot"] = to_arrays(seeds_at([[(0, 100, 40)], [], [(5, 300, 10)]]), [150] * 3)
    # clusters of rising score: the threshold rises twice, and clusters under
    # it are refused; reads without a seed and a negative starting threshold
    # accept their empty slots; a read of ten seeds in one cluster sets S
    rows = [[(0, 100, 30), (0, 500, 90), (0, 900, 41), (0, 1300, 160), (0, 1700, 100),
             (0, 2100, 20)], [], [], [(t, 3000 + t, 13) for t in range(10)]]
    pd, gp, ln, n, thr0 = to_arrays(seeds_at(rows), [150] * 4)
    thr0[1:3] = (-10, -60)
    cases["threshold_rises"] = (pd, gp, ln, n, thr0)
    return {k: (keys.astype(np.int32), *v) for k, v in cases.items()}


def run_both(args):
    keys, pd, gp, ln, n, thr0 = args
    S = pd.shape[1]
    want = jcl.cluster_illumina(jnp.asarray(keys), pd, gp, ln, n, thr0, np.int32(MAX_GAPS),
                                max_seeds=S)
    got = tcl.cluster_illumina(*(torch.from_numpy(a) for a in args), MAX_GAPS, max_seeds=S)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


CASES = ["random_200", "wide_chunks", "no_seeds", "negative_posdiffs", "chromosome_keys",
         "gap_edges", "one_slot", "threshold_rises"]


@pytest.mark.parametrize("name", CASES)
def test_cluster_plain_matches_jax(genome, name):
    gidx, _ = genome
    args = cluster_cases(gidx.chr_map[0], gidx.two_genome_size)[name]
    want, got = run_both(args)
    for w, g, what in zip(want, got, ("cluster_id", "accept", "scores")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        np.testing.assert_array_equal(g, w, err_msg=what)
    cid, accept, _ = want
    if name == "random_200":
        assert (cid.max(axis=1) >= 1).sum() > 20 and accept.any()
    if name == "threshold_rises":
        # 30 under thr0 30; 90 taken (thr 40); 41 taken; 160 taken (thr 110); 100 refused
        np.testing.assert_array_equal(accept[0, :6], [False, True, True, True, False, False])
        assert accept[1:3].all() and not accept[0, 6:].any()
        assert accept[3].tolist() == [True] + [False] * 9
    if name == "gap_edges":
        np.testing.assert_array_equal(cid[:, :3], [[0, 0, 1], [0, 1, 1]])
    if name == "chromosome_keys":
        assert (cid[:, 1] == 1).any() and (cid[:, 1] == 0).any()


def seed_copies(lists, seed_cls):
    return [[seed_cls(s.simple, s.rpos, s.gpos, s.rlen, s.glen, s.posdiff) for s in seeds]
            for seeds in lists]


def cand_view(cands):
    return [(c.score, c.posdiff, c.paired_idx,
             [(s.simple, s.rpos, s.gpos, s.rlen, s.glen, s.posdiff) for s in c.seeds])
            for c in cands]


def test_cluster_batch_to_candidates_matches_jax(genome):
    """The port's Candidate lists equal kart_tpu's wrapper's and the host
    clustering's (gen_candidates_illumina), on the 200 random reads and on
    reads of every length class."""
    gidx, jgidx = genome
    rng = np.random.default_rng(5)
    lists = _random_seed_lists(jgidx, rng, 200, 120) + [[]]
    rlens = [int(x) for x in rng.integers(1, 300, len(lists))]
    want = jcl.cluster_batch_to_candidates(jgidx, lists, rlens, MAX_GAPS)
    port_lists = seed_copies(lists, Seed)
    got = tcl.cluster_batch_to_candidates(gidx, port_lists, rlens, MAX_GAPS, device="cpu")
    assert [cand_view(c) for c in got] == [cand_view(c) for c in want]
    host = [gen_candidates_illumina(r, s, gidx, MAX_GAPS)
            for r, s in zip(rlens, seed_copies(lists, Seed))]
    assert [cand_view(c) for c in got] == [cand_view(c) for c in host]
    assert sum(len(c) for c in got) > 100
    # a candidate's seeds are copies, sorted by gPos; the input lists are untouched
    given = {id(s) for seeds in port_lists for s in seeds}
    for c in (c for cands in got for c in cands):
        assert not given & {id(s) for s in c.seeds}
        assert [(s.gpos, s.rpos) for s in c.seeds] == sorted((s.gpos, s.rpos) for s in c.seeds)
    assert [[(s.rpos, s.gpos) for s in x] for x in port_lists] == [
        [(s.rpos, s.gpos) for s in x] for x in lists]


def test_int32_guard_refuses_a_large_index():
    """An index of 2**31 text bases or more is refused with a ValueError that
    names the limit, not wrapped; one just under it passes the guard.  A host
    value past int32 is refused too.  (The mapper's two hooks call the guard:
    tests/test_torch_slice.py holds them to it.)"""
    big = types.SimpleNamespace(two_genome_size=2**31)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        i32.check_int32_index(big, "device clustering")
    i32.check_int32_index(types.SimpleNamespace(two_genome_size=2**31 - 1), "x")
    for bad in (2**31, -(2**31) - 1):
        with pytest.raises(ValueError, match="int32"):
            i32.int32_array([0, bad], "seed gpos")
    edge = i32.int32_array([-(2**31), 2**31 - 1], "seed gpos")
    assert edge.dtype == np.int32 and edge.tolist() == [-(2**31), 2**31 - 1]
