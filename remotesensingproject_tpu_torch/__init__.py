"""remotesensingproject_tpu_torch — the light-field depth engine in
PyTorch and CUDA for an NVIDIA H100.

A port of ``remotesensingproject_tpu`` (JAX on a TPU), which stays the
reference.  Plain tensor code is PyTorch; the three sweeps (pixel, row and
tile), the selective median and the line paint are CUDA C++ kernels
(``csrc/``), built with nvcc at first use.  ``bench`` runs the
benchmark scenes of the repository's ``bench.py`` with its gates, and
``native/`` reads frame folders with a threaded C++ decoder (built with
g++ at first use).
Entry points run on CUDA unless the caller passes ``device="cpu"``, where
the plain PyTorch version of every kernel runs instead.
"""

from . import utils  # noqa: F401
from .config import DEFAULT_PARAMS, DEFAULT_PYRAMID, DepthParams, PyramidParams
from .types import DTYPE, SQRT3, norm, normsq
from .ops.normalize import normalize_volume
from .ops.edge_confidence import edge_confidence_volume
from .ops.sweep import sweep_epi, sweep_pile
from .models.depth1d import Depth1DComputer
from .models.depth2d import Depth2DComputer
from .models.fine_to_coarse import FineToCoarse
from .models.pile import Depth1DComputerPile

__version__ = "0.1.0"

__all__ = ["DEFAULT_PARAMS", "DEFAULT_PYRAMID", "DepthParams",
           "PyramidParams", "DTYPE", "SQRT3", "norm", "normsq",
           "normalize_volume", "edge_confidence_volume", "sweep_epi",
           "sweep_pile", "Depth1DComputer", "Depth1DComputerPile",
           "Depth2DComputer", "FineToCoarse"]
