"""The plain reference of the port's benchmark: a frozen copy of the
plain path of ``mistra_tpu_torch`` (every module that ``Model`` runs in
the btz96 and multiphase configurations), taken at commit b2518445.

Each file names the file it was copied from.  What differs from the
port: the Bott advection always runs the plain version
(``physics/growth.py``), the batched inverse runs the plain Gauss-Jordan
on the CPU and ``torch.linalg.inv`` on a card (``chemistry/lu.py``), and
``Model`` holds no nucleation (``model.py``).  It imports torch and numpy
only: no module of ``mistra_tpu_torch``, of ``mistra_tpu`` or of JAX, and
nothing the program made (the benchmark gives it the same input files).
"""

from .config import GridParams, MistraConfig
from .model import Model
from .state import ModelState

__all__ = ["GridParams", "MistraConfig", "Model", "ModelState"]
