"""eagleeverything_tpu_torch — the PyTorch/CUDA port of the JAX package
(eagleeverything_tpu).

The multiple-locus LMM scan of the JAX package, in PyTorch, with its TPU
(Pallas) kernels written by hand in CUDA C++ for NVIDIA Hopper. It imports
neither JAX nor the JAX package; the JAX package is its reference, and the
tests run the same inputs through both.

Public API (the JAX package's, the reference's exported R surface):

- :func:`read_marker`  — genotype ingestion (ASCII / PLINK .ped/.bed /
  VCF, native C++ parsing) into memory or a sharded genotype store
                                                  (reference: ``ReadMarker()``)
- :func:`read_pheno`, :func:`read_map`, :func:`read_zmat`
                                  (reference: ``ReadPheno/ReadMap/ReadZmat()``)
- :func:`am`           — the scan on the exact eigenbasis engine (the default
  up to ``matfree_min_n`` individuals; torch ops on the device), on the
  matrix-free engine over the device-resident 2-bit packed stack (the
  default above it; the hand-written kernels) or on the dense oracle
                                                  (reference: ``AM()``)
- :func:`am_multi`     — several traits in one pass, on either engine
- :func:`fpr4am`       — extBIC λ calibration by trait permutation, on
  either engine                                   (reference: ``FPR4AM()``)
- :func:`summary_am`   — Wald tests for the selected markers, exact or
  matrix-free                                     (reference: ``SummaryAM()``)
- :func:`plot_am`      — Manhattan plot (matplotlib, or a standalone .html)
                                                  (reference: ``PlotAM()``)
- :func:`open_gui`     — the browser front end    (reference: ``OpenGUI()``)

plus :class:`GenoHandle`, :class:`GenotypeStore` and :class:`EagleConfig`.
Entry points that touch the device run on CUDA unless the caller passes
``device="cpu"``.
"""

from eagleeverything_tpu_torch.api.am import am, am_multi
from eagleeverything_tpu_torch.api.fpr import fpr4am
from eagleeverything_tpu_torch.api.plot import plot_am
from eagleeverything_tpu_torch.api.read import (
    GenoHandle,
    read_map,
    read_marker,
    read_pheno,
    read_zmat,
)
from eagleeverything_tpu_torch.api.summary import summary_am
from eagleeverything_tpu_torch.gui import open_gui
from eagleeverything_tpu_torch.io.genostore import GenotypeStore
from eagleeverything_tpu_torch.utils.config import EagleConfig

__version__ = "0.1.0"

__all__ = [
    "read_marker",
    "read_pheno",
    "read_map",
    "read_zmat",
    "am",
    "am_multi",
    "fpr4am",
    "summary_am",
    "plot_am",
    "open_gui",
    "GenoHandle",
    "GenotypeStore",
    "EagleConfig",
    "__version__",
]
