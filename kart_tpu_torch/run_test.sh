#!/bin/bash
# Smoke test of the PyTorch/CUDA port, mirroring the repository's run_test.sh:
# build an E. coli-scale index with the port, check the exact .bwt artifact
# size, map simulated PE reads with the port's native mode and check their
# accuracy with the evaluator, then map them again device-pipelined
# (KART_SEED_MODE=device) and require the same SAM bytes.
#
#   bash kart_tpu_torch/run_test.sh          # the device run on the CUDA card
#   bash kart_tpu_torch/run_test.sh --cpu    # the device run's plain versions on the CPU
#
# KART_TPU_TEST_DIR sets the work directory, PYTHON the interpreter.
set -e
cd "$(dirname "$0")/.."
PYTHON=${PYTHON:-python3}
WORK=${KART_TPU_TEST_DIR:-${TMPDIR:-/tmp}/kart_tpu_torch_smoke}
case "$1" in
    "") DEVICE_FLAG=() ;;
    --cpu) DEVICE_FLAG=(-cpu) ;;
    *) echo "usage: $0 [--cpu]" >&2; exit 2 ;;
esac
mkdir -p "$WORK"

echo
echo "Test1 -- Generate index files for a synthetic E.coli-scale reference"
"$PYTHON" - "$WORK" <<'EOF'
import sys, numpy as np
work = sys.argv[1]
rng = np.random.default_rng(7)
seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=4639680)
with open(f"{work}/ecoli.fa", "wb") as f:
    f.write(b">ecoli_synthetic\n")
    s = seq.tobytes()
    for j in range(0, len(s), 70):
        f.write(s[j:j+70] + b"\n")
EOF
"$PYTHON" -m kart_tpu_torch.cli index "$WORK/ecoli.fa" "$WORK/EcoliIdx"

FILESIZE=$(du -sb "$WORK/EcoliIdx.bwt" | awk '{ print $1 }')
if [ "$FILESIZE" == 4639752 ]; then
    echo "[Making the index files successfully! (.bwt == 4639752 bytes)]"
else
    echo "[Failed: .bwt size $FILESIZE != 4639752]"
    exit 1
fi

echo
echo "Test2 -- Align 2000 simulated PE reads"
"$PYTHON" -m kart_tpu_torch.tools.simulate_reads "$WORK/ecoli.fa" "$WORK/r1.fq" "$WORK/r2.fq" -N 2000 -l 150 -S 42
KART_SEED_MODE=native "$PYTHON" -m kart_tpu_torch.cli -i "$WORK/EcoliIdx" -f "$WORK/r1.fq" -f2 "$WORK/r2.fq" -o "$WORK/alignment.sam"
"$PYTHON" -m kart_tpu_torch.tools.evaluate_sam "$WORK/alignment.sam"
KART_SEED_MODE=device "$PYTHON" -m kart_tpu_torch.cli -i "$WORK/EcoliIdx" -f "$WORK/r1.fq" -f2 "$WORK/r2.fq" -o "$WORK/alignment_device.sam" "${DEVICE_FLAG[@]}"
if cmp -s "$WORK/alignment.sam" "$WORK/alignment_device.sam"; then
    echo "[The device-pipelined SAM is byte-equal to the native SAM]"
else
    echo "[FAILED: the device-pipelined SAM differs from the native SAM]"
    exit 1
fi

echo
echo "Test3 -- Golden SAM equality vs reference Kart (when oracle is built)"
if [ -x .refbuild/bin/kart ]; then
    .refbuild/bin/bwt_index "$WORK/ecoli.fa" "$WORK/RefIdx" > /dev/null
    .refbuild/bin/kart -t 1 -i "$WORK/RefIdx" -f "$WORK/r1.fq" -f2 "$WORK/r2.fq" -o "$WORK/ref.sam" > /dev/null 2>&1
    if diff -q "$WORK/alignment.sam" "$WORK/ref.sam" > /dev/null; then
        echo "[SAM output is bit-identical to reference Kart]"
    else
        echo "[FAILED: SAM differs from reference]"
        exit 1
    fi
else
    echo "(reference oracle not built; skipping golden diff)"
fi

echo
echo "[End of test]"
