"""PyTorch/CUDA port of ``torchgpipe_tpu`` for NVIDIA Hopper (H100).

The JAX package ``torchgpipe_tpu`` is the reference; this package mirrors
its module names (``gpipe``, ``pipeline``, ``microbatch``, ``partition``,
``checkpoint``, ``skip``, ``batchnorm``, ``balance``,
``models.transformer``, ``models.generation``, ``models.resnet``,
``models.moe``, ``models.quant``, ``auxgrad``,
``ops.flash_attention``, ``ops.nn``, ``serving``, ``obs``,
``resilience``, ``tune``)
and replaces each Pallas TPU kernel with a kernel
written by hand in CUDA C++ for ``sm_90a`` (``csrc/``).  Importing the
package builds nothing: kernels compile at their first launch
(``ops._build``).
"""

from torchgpipe_tpu_torch.gpipe import GPipe

__all__ = ["GPipe"]
__version__ = "0.1.0"
