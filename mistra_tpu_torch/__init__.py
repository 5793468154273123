"""PyTorch/CUDA port of MISTRA-TPU: the BTZ96 column minute step
(meteorology + 2-D spectral bin microphysics, chemistry and radiation off)
on batched columns, with the Bott advection as hand-written CUDA kernels.

Imports torch and numpy only; the JAX package ``mistra_tpu`` is its
reference and is never imported here.
"""

from .config import GridParams, MistraConfig, config_from_namelist
from .grids import make_grids
from .model import Model
from .state import ModelState, state_from_numpy, state_to_numpy

__version__ = "0.1.0"
__all__ = [
    "GridParams", "MistraConfig", "config_from_namelist", "make_grids",
    "Model", "ModelState", "state_from_numpy", "state_to_numpy",
]
