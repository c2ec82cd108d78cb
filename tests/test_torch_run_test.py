"""The port's smoke test (kart_tpu_torch/run_test.sh) on the CPU: it builds
the E. coli-scale index with the port, maps the simulated pairs in the
native mode and again device-pipelined with -cpu, and passes; kart_tpu's CLI
on the same index and reads writes the same SAM bytes as the port."""

import os
import subprocess
import sys
from pathlib import Path

from kart_tpu import cli as jax_cli

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "kart_tpu_torch" / "run_test.sh"


def test_run_test_sh_cpu(tmp_path):
    env = dict(os.environ, KART_TPU_TEST_DIR=str(tmp_path), PYTHON=sys.executable,
               JAX_PLATFORMS="cpu")
    env.pop("KART_SEED_MODE", None)
    proc = subprocess.run(["bash", str(SCRIPT), "--cpu"], cwd=tmp_path, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=600)
    out = proc.stdout  # the evaluator writes to stderr
    assert proc.returncode == 0, out[-6000:]
    for line in ("[Making the index files successfully! (.bwt == 4639752 bytes)]",
                 "# of reads= 1000", "# of mapped reads= 1000 (100.0%)",
                 "precision= 1000 (100.0%)", "recall= 1000 (100.0%)",
                 "[The device-pipelined SAM is byte-equal to the native SAM]", "[End of test]"):
        assert line in out, line
    port_sam = (tmp_path / "alignment.sam").read_bytes()
    assert (tmp_path / "alignment_device.sam").read_bytes() == port_sam
    # kart_tpu on the same index (the port's, byte for byte kart_tpu's) and reads
    w = str(tmp_path)
    assert jax_cli.main(["kart-tpu", "-i", f"{w}/EcoliIdx", "-f", f"{w}/r1.fq", "-f2",
                         f"{w}/r2.fq", "-o", f"{w}/jax.sam"]) == 0
    assert (tmp_path / "jax.sam").read_bytes() == port_sam


def test_run_test_sh_drives_the_port():
    """The script runs only the port's modules: never kart_tpu's CLI or the
    repository's tools/ scripts."""
    text = SCRIPT.read_text()
    for mod in ("kart_tpu_torch.cli index", "kart_tpu_torch.tools.simulate_reads",
                "kart_tpu_torch.tools.evaluate_sam", "KART_SEED_MODE=device"):
        assert mod in text, mod
    assert "kart_tpu.cli" not in text and "tools/" not in text
