"""The reference genome of a configuration and the benchmark's cache of it.

`make_repeat_genome` is a copy of `kart_tpu_torch/tools/simdata.py`'s (itself
bench.py's recipe): a random genome with rRNA-like, IS-like, REP-like and
tandem repeat families, so that seeding meets real occurrence pressure.  The
same length and seed give the same bytes as simdata's at its own length.

The genome belongs to the deployment, so it comes from the configuration's
fixed seed and is made once per checkout: `cache_dir` names a fixed
directory inside the checkout for it, the program's index built from it and
the reference's own suffix array.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", "_cache")
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_repeat_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    """Random genome of `length` ASCII bases with implanted repeat families
    (tandem and dispersed), drawn in simdata's order."""
    seq = rng.choice(_BASES, size=length)

    def diverge(frag, rate):
        frag = frag.copy()
        n = rng.binomial(len(frag), rate)
        if n:
            idx = rng.integers(0, len(frag), size=n)
            frag[idx] = _BASES[rng.integers(0, 4, size=n)]
        return frag

    def implant(frag):
        p = int(rng.integers(0, length - len(frag)))
        seq[p : p + len(frag)] = frag

    # rRNA-operon-like: 7 near-identical 5 kb copies
    src = rng.choice(_BASES, size=5000)
    for _ in range(7):
        implant(diverge(src, 0.005))
    # IS-element-like: 5 families x 10 copies of 1.2 kb
    for _ in range(5):
        src = rng.choice(_BASES, size=1200)
        for _ in range(10):
            implant(diverge(src, 0.015))
    # REP-motif-like: 500 copies of a 40 bp motif
    src = rng.choice(_BASES, size=40)
    for _ in range(500):
        implant(diverge(src, 0.05))
    # tandem arrays: 30 loci, unit 20-200 bp x 3-8 copies
    for _ in range(30):
        unit = rng.choice(_BASES, size=int(rng.integers(20, 200)))
        arr = np.concatenate([diverge(unit, 0.01) for _ in range(int(rng.integers(3, 8)))])
        implant(arr)
    return seq


def genome_spec(config: dict) -> dict:
    """The part of a configuration that fixes the genome's bases."""
    g = config["genome"]
    return {"recipe": g["recipe"], "bases": int(g["bases"]), "seed": int(g["seed"])}


def cache_dir(config: dict, root: str = CACHE) -> str:
    """The fixed directory of a genome's cached files: configurations with
    the same genome share it."""
    key = hashlib.sha256(json.dumps(genome_spec(config), sort_keys=True).encode()).hexdigest()
    return os.path.join(root, "genome_" + key[:16])


def genome_bases(config: dict) -> np.ndarray:
    """The configuration's genome as ASCII bases, made from its seed."""
    spec = genome_spec(config)
    if spec["recipe"] != "repeat_families":
        raise ValueError(f"unknown genome recipe {spec['recipe']!r}")
    return make_repeat_genome(np.random.default_rng(spec["seed"]), spec["bases"])


def save_atomic(path: str, write) -> None:
    """write(f) into path.tmp, then rename it to path."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def write_fasta(path: str, seq: np.ndarray, name: bytes) -> None:
    """One record, 70 bases a line."""
    s = seq.tobytes()

    def write(f):
        f.write(b">" + name + b"\n")
        for j in range(0, len(s), 70):
            f.write(s[j : j + 70] + b"\n")

    save_atomic(path, write)
