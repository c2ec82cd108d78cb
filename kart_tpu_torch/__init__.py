"""kart-tpu-torch: the PyTorch and CUDA port of kart-tpu.

The JAX package `kart_tpu` is the reference the port is held against.  This
package stands on its own code: it keeps its own copy of the framework-free
layers (index, io, the C++ runtime under native/, the host pipeline,
ops/fm_ref.py) beside the ported device parts, and imports `torch`, never
`jax` and nothing of `kart_tpu`.
"""

__version__ = "0.1.0"
