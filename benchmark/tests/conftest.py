"""Shared pieces of the benchmark's CPU tests: the real BENCHMARK.json's
cells cut to a tiny genome and pool, and a cache directory of their own."""

import os
import time

import pytest

from benchmark import harness

TINY_GENOME = 400_000


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


def tiny(workload: str, **traffic_changes):
    """(bench, cell, config, traffic) of a real cell at a tiny size."""
    bench, cell, config, traffic = harness.load_cell(harness.ROOT, workload)
    config = dict(config, genome=dict(config["genome"], bases=TINY_GENOME))
    if traffic["kind"] == "long":
        traffic = dict(traffic, group_reads=4, pool_groups=4, min_len=300, max_len=600,
                       l_max=1024)
    else:
        traffic = dict(traffic, group_reads=64, pool_groups=4)
    traffic.update(traffic_changes)
    return bench, cell, config, traffic


@pytest.fixture(scope="session")
def cache_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


def run_tiny(workload: str, cache_root: str, seed: int = 2147483999, seconds: float = 0.3,
             **traffic_changes) -> dict:
    bench, cell, config, traffic = tiny(workload, **traffic_changes)
    return harness.run_loaded(bench, cell, config, traffic, seed=seed, seconds=seconds,
                              trace=False, device="cpu", t_start=time.time(),
                              cache_root=cache_root, log=lambda s: None)


WORKLOADS = ("ecoli_pe.pe150", "ecoli_pb.clr6k")
HERE = os.path.dirname(os.path.abspath(__file__))
