"""The port's gather probe: it times by slope as kart_tpu's probe does, on
kart_tpu's index lists, and measures only on a card (without one it exits
non-zero and measures nothing)."""

import contextlib
import functools
import importlib.util
import inspect
import io
import os
import sys

import numpy as np
import pytest
import torch

from kart_tpu_torch.tools import bench_gather

_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                    "bench_gather.py")


def _kart_tpu_probe():
    """kart_tpu's tools/bench_gather.py, loaded by path (numpy only at import)."""
    spec = importlib.util.spec_from_file_location("kart_tpu_bench_gather", _REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _kart_tpu_inputs(h, runs):
    """What kart_tpu's probe main() hands to its timer at --h h --runs runs,
    run on the CPU with `time_slope` replaced by a recorder that times
    nothing: {formulation: (gather closure, gather_latencies)}."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    mod = _kart_tpu_probe()
    closures = []

    def record(gather_one, n_small=8, n_big=136):
        closures.append(gather_one)
        return 1e-6

    mod.time_slope = record
    argv = sys.argv
    sys.argv = [_REF, "--h", str(h), "--runs", str(runs)]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            results = mod.main()
    finally:
        sys.argv = argv
    assert len(results) == len(closures)
    return {r["formulation"]: (f, r["gather_latencies"]) for r, f in zip(results, closures)}


def _nonlocal(fn, name):
    return np.asarray(inspect.getclosurevars(fn).nonlocals[name])


def _kart_tpu_lists(h, runs, R):
    """kart_tpu's table, index variants and (rid, pos, off, HR) for R-word
    rows, read from the closures its main() times: the row_R and
    two_level_R lambdas' defaults, f_pallas's closure for R = 128."""
    ref = _kart_tpu_inputs(h, runs)
    flat = ref["flat"][0]
    table, idx = _nonlocal(flat, "table"), _nonlocal(flat, "idx_all")
    if R == 128:
        f_pallas, hr = ref["pallas_dma_row128x8"]
        return table, idx, (_nonlocal(f_pallas, "ridp_all"), None, None, hr)
    two, hr = ref[f"two_level_{R}"]
    _, rid, pos, off = (np.asarray(a) for a in two.__defaults__)
    np.testing.assert_array_equal(np.asarray(ref[f"row_{R}"][0].__defaults__[1]), rid)
    return table, idx, (rid, pos, off, hr)


def test_bench_gather_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        bench_gather.main([])
    assert exc.value.code not in (0, None)
    assert "formulation" not in capsys.readouterr().out


@pytest.mark.parametrize("noisy", [(), (0, 3), (1, 4, 5)])
def test_time_slope_recovers_the_per_call_time(noisy):
    d, g = 3.5e-5, 2.25e-6
    calls = []

    def run(n):
        calls.append(n)
        t = d + n * g
        return t + 1e-3 if len(calls) - 1 in noisy else t  # a late replay on some calls

    assert bench_gather.time_slope(run) == pytest.approx(g, rel=1e-9)
    assert calls == [8, 136] * 3


def test_time_slope_is_zero_when_the_big_loop_is_not_slower():
    assert bench_gather.time_slope(lambda n: 1e-3) == 0.0
    assert bench_gather.time_slope(lambda n: 1e-3 - n * 1e-7) == 0.0


def test_time_slope_defaults_match_kart_tpu():
    ref = inspect.signature(_kart_tpu_probe().time_slope).parameters
    ours = inspect.signature(bench_gather.time_slope).parameters
    assert (ref["n_small"].default, ref["n_big"].default) == (8, 136)
    assert (ours["n_small"].default, ours["n_big"].default) == (8, 136)
    assert bench_gather.NV == _kart_tpu_probe().NV


@pytest.mark.parametrize("R", [8, 16, 32, 128])
def test_row_ids_match_kart_tpu(R):
    h, runs = 16384, 4096
    table_ref, idx_ref, want = _kart_tpu_lists(h, runs, R)
    _, table, idx_v = bench_gather.make_variants(h, bench_gather.N_TABLE, runs)
    np.testing.assert_array_equal(table, table_ref)
    np.testing.assert_array_equal(np.stack(idx_v), idx_ref)
    got = bench_gather.row_ids(idx_v, R)
    for a, b in zip(got, want):
        if b is not None:  # kart_tpu's row-128 probe keeps no pos or off
            np.testing.assert_array_equal(a, b)
    if R == 128:
        rid, hr = got[0], got[3]
        assert hr == 8192  # at most 4,113 distinct rows, padded with row 0
        distinct = max(len(np.unique(v // 128)) for v in idx_v)
        assert distinct == 4113
        assert (rid[:, distinct:] == 0).all()


def test_row_ids_at_the_second_size():
    h, runs = 262144, 65536
    _, idx_ref, (rid, _, _, hr) = _kart_tpu_lists(h, runs, 128)
    _, _, idx_v = bench_gather.make_variants(h, bench_gather.N_TABLE, runs)
    np.testing.assert_array_equal(np.stack(idx_v), idx_ref)
    got, _, _, got_hr = bench_gather.row_ids(idx_v, 128)
    np.testing.assert_array_equal(got, rid)
    assert got_hr == hr == 65536
    assert max(len(np.unique(v // 128)) for v in idx_v) == 43838


def test_row_gather_takes_only_cuda_tensors():
    from kart_tpu_torch import kernels

    t = torch.zeros((4, 128), dtype=torch.int32)
    for n in (2, 0):
        with pytest.raises(ValueError, match="cuda"):
            kernels.row_gather(t, torch.zeros(n, dtype=torch.int32))
    assert kernels.row_gather.launches == 0


def test_busy_seconds_is_the_union_of_the_spans():
    """Overlapping kernels and copies count once; the window runs from the
    first start to the last end (microseconds in, seconds out)."""
    from kart_tpu_torch.tools.bench_kernels import busy_seconds

    spans = [(0.0, 10.0, "a"), (5.0, 20.0, "b"), (6.0, 8.0, "c"), (30.0, 40.0, "d")]
    busy, window = busy_seconds(spans)
    assert busy == pytest.approx(30e-6) and window == pytest.approx(40e-6)
    assert busy_seconds([(3.0, 4.0, "a")]) == (pytest.approx(1e-6), pytest.approx(1e-6))
