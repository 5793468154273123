"""PyTorch/CUDA port of MISTRA-TPU: the BTZ96 column minute step
(meteorology + 2-D spectral bin microphysics + PIFM2 radiation, chemistry
off) on batched columns, with the Bott advection as hand-written CUDA
kernels and the radiation (``radiation/``) in plain torch; the chem=T
column minute with photolysis (``photolysis/``) and the gas-phase or the
multiphase chemistry driver (``chemistry/``); and their stiff chemistry
solve (Ros3 with the block-arrow stage solver), whose batched inverse is
a hand-written CUDA kernel.

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
