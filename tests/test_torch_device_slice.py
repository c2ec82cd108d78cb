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


# ---------------------------------------------------------------------------
# PacBio (-pacbio): SensitiveMode seeding in all three modes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pacbio_data(device_slice_data):
    """45 PacBio-like reads of 220-700 bases from both chromosomes (6%
    substitutions, 3% deletions, 3% insertions; every seventh from the
    reverse strand), and 30 more cut from one 400-base stretch."""
    from kart_tpu.index.format import parse_fasta

    d = device_slice_data
    seqs = [np.frombuffer(s.seq, np.uint8) for s in parse_fasta(str(d / "g.fa"))]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")

    def noisy(rng, src, rl):
        out, j = [], 0
        while j < len(src) and len(out) < rl:
            r = rng.random()
            if r < 0.06:
                out.append(acgt[rng.integers(0, 4)])
                j += 1
            elif r < 0.09:
                j += 1
            elif r < 0.12:
                out.append(acgt[rng.integers(0, 4)])
            else:
                out.append(src[j])
                j += 1
        return bytes(out[:rl])

    rng = np.random.default_rng(9)
    with open(d / "pb.fq", "wb") as f:
        for i in range(45):
            g = seqs[i % 2]
            rl = int(rng.integers(220, 700))
            p = int(rng.integers(0, len(g) - 2 * rl))
            seq = noisy(rng, g[p : p + int(rl * 1.3)], rl)
            if i % 7 == 0:
                seq = seq.translate(comp)[::-1]
            f.write(b"@pb%d:Pos=%d\n%s\n+\n%s\n" % (i, p + 1, seq, b"I" * len(seq)))
    with open(d / "pb_one_place.fq", "wb") as f:
        for i in range(30):
            seq = noisy(rng, seqs[0][20000 + 3 * i : 20600 + 3 * i], 400)
            f.write(b"@one%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)))
    return d


def run_pacbio(d, reads, tag, monkeypatch, capsys, *, backend=None, env=None):
    """kart_tpu's and the port's (-cpu) SAM bytes of one mode, and the
    port's stdout."""
    for k in ("KART_SEED_MODE", "KART_KMER_GATE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    args = ["-i", str(d / "idx"), "-f", str(d / reads), "-pacbio", "-silent"]
    args += ["-backend", backend] if backend else []
    assert jax_cli.main(["kart-tpu", *args, "-o", str(d / f"pb_jax_{tag}.sam")]) == 0
    capsys.readouterr()
    assert torch_cli.main(["kart-tpu-torch", *args, "-cpu", "-o", str(d / f"pb_port_{tag}.sam")]) == 0
    out = capsys.readouterr().out
    return (d / f"pb_jax_{tag}.sam").read_bytes(), (d / f"pb_port_{tag}.sam").read_bytes(), out


@pytest.mark.parametrize("mode", ["native", "device", "device_gate0", "python"])
def test_pacbio_sam_matches(pacbio_data, mode, monkeypatch, capsys):
    """-pacbio in the native, device-pipelined and python modes, and the
    device mode with the funnel's gate closed (the SensitiveMode FM stepper
    seeds the group): the SAM bytes of kart_tpu in the same mode, which are
    those of its native mode."""
    d = pacbio_data
    env = {"native": {}, "device": {"KART_SEED_MODE": "device"},
           "device_gate0": {"KART_SEED_MODE": "device", "KART_KMER_GATE": "0"}, "python": {}}[mode]
    want, got, out = run_pacbio(d, "pb.fq", mode, monkeypatch, capsys,
                                backend="python" if mode == "python" else None, env=env)
    recs = [ln for ln in want.splitlines() if not ln.startswith(b"@")]
    assert len(recs) == 45 and sum(1 for r in recs if not int(r.split(b"\t")[1]) & 4) >= 40
    assert got == want
    if mode != "native":
        native = run_pacbio(d, "pb.fq", "native_ref", monkeypatch, capsys)[0]
        assert want == native
    if mode.startswith("device"):
        groups, flagged, on_dev, on_host = device_counts(out)
        assert groups == 1 and flagged == on_dev + on_host
    elif mode == "python":
        assert re.search(r"NW fragments on cpu = \d+, on the host = \d+, memo misses = 0", out)


def test_pacbio_flagged_lanes_are_reseeded(workdir, monkeypatch, capsys):
    """Reads across the copies of a 40-copy repeat: their seeds carry some 40
    occurrences each, so the funnel's hit budget and the stream's 64 slots a
    lane both overflow; the flagged lanes are re-seeded by the SensitiveMode
    FM stepper in batches of the PacBio bucket, and those that overflow
    again on the host.  Same SAM as kart_tpu, group by group."""
    from test_torch_kmer_seed import build_repeat_genome, repeat_batch

    d = workdir / "torch_device_slice_pb_repeat"
    gidx = build_repeat_genome(d)
    reads, rlens = repeat_batch(gidx, 24, 512)
    with open(d / "pb_repeat.fq", "wb") as f:
        for i, (r, rl) in enumerate(zip(reads, rlens)):
            seq = np.frombuffer(b"ACGT", np.uint8)[r[:rl]].tobytes()
            f.write(b"@rep%d\n%s\n+\n%s\n" % (i, seq, b"I" * rl))
    monkeypatch.setenv("KART_DEVICE_GROUP", "1")  # groups of 10 reads in 16 lanes
    want, got, out = run_pacbio(d, "pb_repeat.fq", "flagged", monkeypatch, capsys,
                                env={"KART_SEED_MODE": "device"})
    assert got == want
    groups, flagged, on_dev, on_host = device_counts(out)
    assert groups == 3 and flagged >= 12 and on_dev >= 3 and on_host >= 3
    assert flagged == on_dev + on_host


# ---------------------------------------------------------------------------
# Budgets from the environment; a re-seed batch past the last bucket
# ---------------------------------------------------------------------------

_ENV_BUDGET_RUNS = """
import sys
from kart_tpu import cli as jax_cli
from kart_tpu.pipeline import mapper as jm
from kart_tpu_torch import cli as torch_cli
from kart_tpu_torch.pipeline import mapper as tm
idx, r1, out = sys.argv[1:4]
flagged_jax, flagged_port = [], []
reseed = jm.KartMapper._reseed_device_flat
def spy(self, bad, *a):
    flagged_jax.append(len(bad))
    return reseed(self, bad, *a)
jm.KartMapper._reseed_device_flat = spy
finalize = tm.TorchKartMapper._finalize_seed
def spy_port(self, *a):
    res = finalize(self, *a)
    flagged_port.append(self.group_log[-1]["flagged"])
    return res
tm.TorchKartMapper._finalize_seed = spy_port
args = ["-i", idx, "-f", r1, "-silent"]
assert jax_cli.main(["kart-tpu", *args, "-o", out + ".jax.sam"]) == 0
assert torch_cli.main(["kart-tpu-torch", *args, "-cpu", "-o", out + ".port.sam"]) == 0
assert open(out + ".jax.sam", "rb").read() == open(out + ".port.sam", "rb").read()
print("FLAGGED", flagged_jax, [n for n in flagged_port if n], len(flagged_port))
"""


def test_hit_budget_from_environment_flags_the_same_lanes(workdir, tmp_path):
    """KART_HIT_BUDGET=1 and KART_SLAB_ROWS=500 in the device-pipelined mode,
    on 1,200 single-end reads of a genome with a 40-copy repeat: the port
    re-seeds as many lanes of each group as kart_tpu does (the funnel's
    flags depend on both variables), and more than with the defaults."""
    import os
    import subprocess

    from test_torch_kmer_seed import build_repeat_genome, make_reads

    d = workdir / "torch_device_slice_env"
    gidx = build_repeat_genome(d)
    reads, rlens = make_reads(gidx, 1200, 150, seed=2)
    with open(d / "se.fq", "wb") as f:
        for i, (r, rl) in enumerate(zip(reads, rlens)):
            seq = np.frombuffer(b"ACGTN", np.uint8)[r[:rl]].tobytes()
            f.write(b"@se%d\n%s\n+\n%s\n" % (i, seq, b"I" * rl))
    repo = Path(__file__).resolve().parent.parent
    counts = {}
    for name, extra in (("defaults", {}), ("small", {"KART_HIT_BUDGET": "1",
                                                      "KART_SLAB_ROWS": "500"})):
        env = dict(os.environ, KART_SEED_MODE="device", KART_DEVICE_GROUP="1",
                   JAX_PLATFORMS="cpu", PYTHONPATH=str(repo), **extra)
        for k in ("KART_HIT_BUDGET", "KART_SLAB_ROWS", "KART_OCC_BUDGET"):
            if k not in extra:
                env.pop(k, None)
        proc = subprocess.run(
            [sys.executable, "-c", _ENV_BUDGET_RUNS, str(d / "idx"), str(d / "se.fq"),
             str(tmp_path / name)],
            capture_output=True, text=True, timeout=900, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        jax_n, port_n, groups = eval(proc.stdout.split("FLAGGED")[1].replace("] [", "], [")
                                     .replace("] ", "], "))
        assert jax_n == port_n and groups == 1, proc.stdout
        counts[name] = sum(port_n)
    assert counts["small"] > counts["defaults"] + 20, counts


def test_reseed_batch_past_the_last_bucket_is_made_even(device_slice_data):
    """16,001 flagged lanes: past the 16,000 bucket the batch is the count
    itself, which pack16 cannot pair; the port rounds it up to even and
    re-seeds every lane exactly."""
    from kart_tpu_torch.index import load_index
    from kart_tpu_torch.pipeline.mapper import TorchKartMapper

    gidx = load_index(str(device_slice_data / "idx"))
    m = TorchKartMapper(gidx, device="cpu")
    rng = np.random.default_rng(6)
    nb, l_max, rl = 16001, 64, 50
    starts = rng.integers(0, gidx.two_genome_size - rl, nb)
    reads = np.full((nb, l_max), 4, np.int8)
    reads[:, :rl] = gidx.ref_codes[starts[:, None] + np.arange(rl)]
    rlens = np.full(nb, rl, np.int32)
    m.group_log.append({})
    out = m._reseed_device_flat(np.arange(nb), reads, rlens, l_max)
    assert len(out) == nb and m.group_log[-1]["reseeded_device"] + m.group_log[-1]["reseeded_host"] == nb
    for i in (0, 1, 8000, nb - 1):
        assert out[i] == m._reseed_host_flat(reads[i, :rl].astype(np.int32))
