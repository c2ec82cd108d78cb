"""kart-tpu-torch: the PyTorch and CUDA port of kart-tpu.

The JAX package `kart_tpu` is the reference; this package imports its
framework-free layers (index, io, host pipeline) and ports the device parts.

Importing any module of `kart_tpu` runs its package `__init__`, which
imports jax, where it is installed, to set up a JAX compilation cache.  The
port needs neither, so it imports the `kart_tpu` package once here with jax
hidden; the layers it then imports need no jax.  Where jax is loaded
already, nothing changes.
"""

import sys

__version__ = "0.1.0"


def _import_kart_tpu_without_jax() -> None:
    if "kart_tpu" in sys.modules or "jax" in sys.modules:
        return
    sys.modules["jax"] = None  # `import jax` raises ImportError meanwhile
    try:
        import kart_tpu  # noqa: F401
    finally:
        del sys.modules["jax"]


_import_kart_tpu_without_jax()
