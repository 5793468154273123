"""Thermodynamic helper functions (torch counterpart of
``mistra_tpu.physics.thermo``; the reference's statement functions, e.g.
``p21``, str.f90:7672-7693)."""

from __future__ import annotations

import torch


def p21(t):
    """Saturation water vapour pressure [Pa] (Magnus form over water)."""
    return 610.7 * torch.exp(17.15 * (t - 273.15) / (t - 38.33))
