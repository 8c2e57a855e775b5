"""Neural ADMIXTURE on PyTorch and CUDA for one NVIDIA H100.

The counterpart of ``neural_admixture_tpu`` (JAX on a TPU), module for
module: the same file layout, file formats and numerics, with the Pallas
kernels rewritten by hand as CUDA C++ for Hopper (``csrc/``, built at first
use by ``_build.py``). It imports neither JAX nor the JAX package; the tests
hold it against that package on the CPU.

Ported so far, on one device and every input format of the JAX package
(PLINK .bed, PGEN, VCF; io/, with the native host decoder of native/):
projective inference (``infer``) and training (``train``: one K or a K
range, unsupervised or supervised), through a counterpart of every Pallas
kernel of the JAX package.
"""
import torch

__version__ = "0.1.0"

# The encoder's linears stay in full fp32 on the card, as they are on the
# CPU and in the JAX package's interpret-mode tests: TF32 keeps only ~10
# mantissa bits. Both switches are set explicitly rather than relying on
# PyTorch's defaults (cuDNN's is on).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
