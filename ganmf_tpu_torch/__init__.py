"""ganmf_tpu_torch: the PyTorch and CUDA port of ganmf_tpu, for one NVIDIA H100.

It keeps the JAX package's module layout and names, and its array layouts at
every public function, so each module has an obvious counterpart in
``ganmf_tpu``. The port imports ``torch`` and never ``jax``: the host code it
shares with ``ganmf_tpu`` is copied, not imported. Every Pallas kernel on a
ported path is a kernel written by hand for Hopper, built from ``csrc/`` at
first use (``ops/_build.py``).

Importing the package applies the numeric settings of ``utils.device``:
no TF32 in float32 matmuls or convolutions.
"""

__version__ = "0.1.0"

from ganmf_tpu_torch.utils.device import cuda_device  # noqa: F401  (applies the TF32 settings)
