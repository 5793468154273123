"""Physical constants of the MISTRA-TPU framework.

Semantics follow the reference model's constant set (see the
reference's src/constants.f90) so that numerical parity tests are
meaningful; values are standard CODATA / WMO constants.
"""

from __future__ import annotations

import math

# Avogadro constant [1/mol]
AVOGADRO = 6.022140857e23
# Thermochemical calorie at 15 degC [J]
CAL15 = 4.1855
# Conversion: mol/m3 -> molecules/cm3 factor [m3/cm3/mol]
CONV1 = AVOGADRO * 1.0e-6
# Molar mass of dry air [kg/mol]
M_AIR = 28.96546e-3
# Molar mass of water [kg/mol]
M_WAT = 18.01528e-3

PI = math.pi
# Degrees -> radians
RAD = PI / 180.0

# Universal gas constant [J/K/mol]
GAS_CONST = 8.3144743
# Specific gas constant of dry air [J/(kg K)]
R0 = GAS_CONST / M_AIR
# Specific gas constant of water vapour [J/(kg K)]
R1 = GAS_CONST / M_WAT

# Density of water [kg/m3]
RHOW = 1000.0
# Density of dry aerosol material [kg/m3]
RHO3 = 2000.0

# Gravitational acceleration [m/s2]
G = 9.80665
# Specific heat of dry air at constant pressure [J/(kg K)]
CP = 1005.0
# Von Karman constant [1]
KAPPA = 0.4

# Dry adiabatic lapse rate g/cp [K/m]
GAMMA_DRY = 0.0098

# Latent heat of vaporisation used by the reference closure [J/kg]
L_V = 2.4774e6

# Mean Coriolis parameter [1/s] (mid-latitude f-plane of the reference)
FCOR = 1.0e-4

# Ratio r0/r1 = 0.62198 and derived factors, kept explicit because the
# reference hard-codes these rounded values in thermodynamic formulas.
EPS_RATIO = 0.62198          # r0/r1
ONE_MINUS_EPS = 0.37802      # 1 - r0/r1
DELTA_RATIO = 0.61           # r1/r0 - 1 (rounded, as used in the reference)
