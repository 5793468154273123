"""PyTorch/CUDA port of MISTRA-TPU: the column minute step (meteorology +
2-D spectral bin microphysics + PIFM2 radiation) on batched columns, with
the Bott advection as hand-written CUDA kernels and the radiation
(``radiation/``) in plain torch; with chem=T, photolysis
(``photolysis/``), the gas-phase or the multiphase chemistry driver
(``chemistry/``) and nucleation (``physics/nucleation.py``), whose stiff
chemistry solve (Ros3 with the block-arrow stage solver) runs a
hand-written CUDA batched inverse; mic=F, the bare-soil surface (isurf=1),
and the box and chamber modes (``boxmodel.BoxModel``).

Imports torch and numpy only; the JAX package ``mistra_tpu`` is its
reference and is never imported here.
"""

from .config import GridParams, MistraConfig, config_from_namelist
from .grids import make_grids
from .model import Model
from .boxmodel import BoxModel
from .state import ModelState, state_from_numpy, state_to_numpy

__version__ = "0.1.0"
__all__ = [
    "GridParams", "MistraConfig", "config_from_namelist", "make_grids",
    "Model", "BoxModel", "ModelState", "state_from_numpy", "state_to_numpy",
]
