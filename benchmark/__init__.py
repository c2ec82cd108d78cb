"""The benchmark of kart_tpu_torch, the PyTorch and CUDA port of kart-tpu.

One run measures one cell of `BENCHMARK.json` (a configuration under a
traffic mix) on one CUDA card: `python3 -m benchmark.run --workload <name>
--seed <n> --seconds <s> --trace <0|1>`.  Everything that belongs to one
configuration, one traffic mix or one metric sits in a file of its own,
found by its name: `configs/<config>.json`, `traffic/<traffic>.json`,
`metrics/<metric>.py`, and the plain reference that a configuration names,
`references/<reference>.py`.
"""
