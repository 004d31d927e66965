"""unet_zoo_tpu_torch — the PyTorch/CUDA port of ``unet_zoo_tpu``.

The JAX package stays the reference; this package mirrors its paths
(``ops``, ``ops/pallas``, ``models``) and imports nothing from it. The hot
kernel is hand-written CUDA for Hopper (``csrc/``), built with ``nvcc`` at
first CUDA use; CPU tensors take each kernel's plain PyTorch version.
Activations are NHWC at every public function, as in the JAX package.

Importing the package imports no submodule and builds nothing.
"""

__version__ = "0.1.0"
