"""eagleeverything_tpu_torch — the PyTorch/CUDA port of the JAX package
(eagleeverything_tpu).

The multiple-locus LMM scan of the JAX package, in PyTorch, with its TPU
(Pallas) kernels written by hand in CUDA C++ for NVIDIA Hopper. It imports
neither JAX nor the JAX package; the JAX package is its reference, and the
tests run the same inputs through both.

This slice carries :func:`am` on the matrix-free engine over the
device-resident 2-bit packed genotype stack (and the dense oracle), the
phenotype and map readers, the genotype store and :class:`EagleConfig`.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from eagleeverything_tpu_torch.api.am import am
from eagleeverything_tpu_torch.api.read import GenoHandle, read_map, read_pheno
from eagleeverything_tpu_torch.io.genostore import GenotypeStore
from eagleeverything_tpu_torch.utils.config import EagleConfig

__version__ = "0.1.0"

__all__ = [
    "am",
    "GenoHandle",
    "read_pheno",
    "read_map",
    "GenotypeStore",
    "EagleConfig",
    "__version__",
]
