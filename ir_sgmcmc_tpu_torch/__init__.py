"""ir-sgmcmc-tpu-torch: the PyTorch/CUDA port of ``ir_sgmcmc_tpu``.

Same layouts and names as the JAX package: fields are ``(…, 3, D, H, W)``
with channel 0 = x (W axis), chains form a leading batch axis, everything is
float32.  The package never imports JAX.  The Pallas kernels of the main
path are hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` at first
use and bound with ``ctypes`` (``kernels/``); a CUDA tensor always goes
through them, and a CPU tensor through their plain PyTorch versions.

Float32 matmuls and convolutions must not run in TF32 for parity with the
reference; the port uses neither (its stencils are shift-and-add), and
``chip_smoke.py`` sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False regardless.
"""

__version__ = "0.1.0"
