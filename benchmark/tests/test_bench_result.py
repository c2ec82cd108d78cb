"""A whole run on the CPU at a tiny size: the result line's keys, and the
traffic generator's guarantees."""

import numpy as np
import pytest

from benchmark import traffic as traffic_mod
from benchmark.tests.conftest import WORKLOADS, run_tiny, tiny


@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line_keys(workload, cache_root):
    r = run_tiny(workload, cache_root)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "compared"
    assert r["correct"] is True
    assert r["attempted"] > 0 and 0 <= r["failed"] < r["attempted"]
    assert set(r["metrics"]) == {"seeded_bases_per_s", "setup_s"}
    for m in r["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert r["device"]["platform"] == "cpu" and r["device"]["count"] == 1
    assert r["compared"] == {"mismatched_reads": {"value": 0, "limit": 0}}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_pool_is_the_seeds(workload):
    """Every seed gets the traffic's one library, and deals its groups in an
    order of its own."""
    _, _, config, traffic = tiny(workload)
    codes = np.random.default_rng(0).integers(0, 4, 50_000).astype(np.uint8)
    a = traffic_mod.make_pool(codes, traffic, "cpu")
    b = traffic_mod.make_pool(codes, traffic, "cpu")
    c = traffic_mod.make_pool(codes, dict(traffic, library_seed=traffic["library_seed"] + 1),
                              "cpu")
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    n_g = traffic["pool_groups"]
    orders = [traffic_mod.group_order(traffic, s) for s in (2**31 + 5, 2**31 + 5, 7, 8, 9)]
    assert orders[0] == orders[1]
    assert all(sorted(o) == list(range(n_g)) for o in orders)
    assert any(o != orders[0] for o in orders[2:])
    reads, rlens = a
    n = n_g * traffic["group_reads"]
    assert reads.shape == (n, traffic["l_max"]) and rlens.shape == (n,)
    inside = np.arange(traffic["l_max"])[None, :] < rlens[:, None]
    assert (reads[inside] <= 3).all() and (reads[~inside] == 4).all()
    if traffic["kind"] == "long":
        assert (rlens >= 0.9 * traffic["min_len"]).all() and (rlens <= traffic["max_len"]).all()
    else:
        assert (rlens == traffic["read_len"]).all()


def test_paired_reads_come_from_both_strands():
    codes = np.random.default_rng(1).integers(0, 4, 20_000).astype(np.uint8)
    p = dict(tiny("ecoli_pe.pe150")[3], sub_rate=0.0, indel_rate=0.0)
    reads, _ = traffic_mod.make_pool(codes, p, "cpu")
    text = codes.tobytes()
    rc = (3 - codes[::-1]).tobytes()
    r1, r2 = reads[0, :150].astype(np.uint8).tobytes(), reads[1, :150].astype(np.uint8).tobytes()
    assert r1 in text and r2 in rc
