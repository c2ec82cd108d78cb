"""The device-pipelined mode end to end on the CPU: `kart_tpu_torch.cli -cpu`
with KART_SEED_MODE=device (13-mer funnel, expand/resolve, stream pack and
FM re-seed as the kernels' plain versions) must write the same SAM bytes as
kart_tpu's device mode on JAX's CPU backend and as kart_tpu's native mode,
for paired and single-end reads, and with a budget small enough that reads
overflow and are re-seeded.  The port's default native mode must agree too.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kart_tpu import cli as jax_cli
from kart_tpu_torch import cli as torch_cli

from conftest import make_genome

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from simulate_reads import simulate  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def device_slice_data(workdir):
    """The 100 kb two-chromosome genome of test_torch_slice (N runs), with
    200 pairs of 100 bp and, for the overflow case, 1,000 pairs of 150 bp."""
    d = workdir / "torch_device_slice"
    d.mkdir(exist_ok=True)
    fa = d / "g.fa"
    fa.write_text(make_genome(np.random.default_rng(1234), [60000, 40000], n_runs=3))
    from kart_tpu.index import build_index

    build_index(str(fa), str(d / "idx"), verbose=False)
    simulate(str(fa), str(d / "r1.fq"), str(d / "r2.fq"), n_reads=400, read_len=100,
             err=0.02, mut=0.01, indel_frac=0.5, seed=3)
    simulate(str(fa), str(d / "o1.fq"), str(d / "o2.fq"), n_reads=2000, read_len=150,
             err=0.02, mut=0.01, indel_frac=0.5, seed=5)
    return d


def run_three(d, reads, tag, monkeypatch, capsys):
    """kart_tpu native, kart_tpu device (JAX CPU), port -cpu device; returns
    the three SAM byte strings and the port's stdout."""
    args = ["-i", str(d / "idx"), *reads, "-silent"]
    monkeypatch.delenv("KART_SEED_MODE", raising=False)
    assert jax_cli.main(["kart-tpu", *args, "-o", str(d / f"native_{tag}.sam")]) == 0
    monkeypatch.setenv("KART_SEED_MODE", "device")
    assert jax_cli.main(["kart-tpu", *args, "-o", str(d / f"jaxdev_{tag}.sam")]) == 0
    capsys.readouterr()
    assert torch_cli.main(["kart-tpu-torch", *args, "-cpu", "-o", str(d / f"port_{tag}.sam")]) == 0
    out = capsys.readouterr().out
    return [(d / f"{k}_{tag}.sam").read_bytes() for k in ("native", "jaxdev", "port")], out


def device_counts(out: str) -> tuple[int, int, int, int]:
    m = re.search(r"device seeding groups on cpu = (\d+), flagged lanes = (\d+), re-seeded on "
                  r"the device = (\d+), on the host = (\d+)", out)
    assert m is not None, out
    return tuple(int(g) for g in m.groups())


@pytest.mark.parametrize("mode", ["pe", "se"])
def test_device_mode_sam_matches(device_slice_data, mode, monkeypatch, capsys):
    d = device_slice_data
    reads = ["-f", str(d / "r1.fq")] + (["-f2", str(d / "r2.fq")] if mode == "pe" else [])
    (native, jaxdev, port), out = run_three(d, reads, mode, monkeypatch, capsys)
    assert native.count(b"\n") > (400 if mode == "pe" else 200)
    assert jaxdev == native
    assert port == native
    groups, flagged, on_dev, on_host = device_counts(out)
    assert groups == 1 and flagged == on_dev + on_host


def test_device_mode_reseed_overflow(device_slice_data, monkeypatch, capsys):
    """KART_OCC_BUDGET=1: 2,000 reads in a 2,048-row batch whose stream has
    2,048 slots, so most reads overflow and are re-seeded by the FM stepper;
    the SAM is unchanged."""
    d = device_slice_data
    monkeypatch.setenv("KART_OCC_BUDGET", "1")
    reads = ["-f", str(d / "o1.fq"), "-f2", str(d / "o2.fq")]
    (native, jaxdev, port), out = run_three(d, reads, "overflow", monkeypatch, capsys)
    assert native.count(b"\n") > 2000
    assert jaxdev == native
    assert port == native
    groups, flagged, on_dev, on_host = device_counts(out)
    assert flagged > 500 and on_dev + on_host == flagged


def test_port_native_mode_sam_matches(device_slice_data, monkeypatch):
    """The port's default backend without KART_SEED_MODE: kart_tpu's host
    C++ engine, the same SAM as kart_tpu's native mode."""
    d = device_slice_data
    monkeypatch.delenv("KART_SEED_MODE", raising=False)
    args = ["-i", str(d / "idx"), "-f", str(d / "r1.fq"), "-f2", str(d / "r2.fq"), "-silent"]
    assert jax_cli.main(["kart-tpu", *args, "-o", str(d / "native_ref.sam")]) == 0
    assert torch_cli.main(["kart-tpu-torch", *args, "-o", str(d / "port_native.sam")]) == 0
    assert (d / "port_native.sam").read_bytes() == (d / "native_ref.sam").read_bytes()


def test_device_mode_without_gpu_fails(device_slice_data, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d = device_slice_data
    monkeypatch.setenv("KART_SEED_MODE", "device")
    rc = torch_cli.main(["kart-tpu-torch", "-i", str(d / "idx"), "-f", str(d / "r1.fq"),
                         "-o", str(d / "nogpu.sam")])
    assert rc != 0
