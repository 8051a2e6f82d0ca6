"""datafusion_comet_tpu_torch: the PyTorch/CUDA port of datafusion_comet_tpu.

A second package beside the JAX one, with the same module layout, so each
module's counterpart is found under the same path. Plain tensor code is
PyTorch; the kernels the JAX package wrote in Pallas for the TPU are
hand-written CUDA C++ for Hopper (``csrc/``), built with nvcc at first use.
Nothing here imports JAX or the JAX package. Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
