"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: requires CUDA, prints the card and its power limit, builds the
     CUDA kernels of mistra_tpu_torch/csrc with nvcc;
  2. kernels against their plain torch versions on the card, at the
     production shape (100 levels x 70 dry bins rows of 70 bins per
     column), float64 and float32, walk band J in {32, 70}; times both
     and sets each time beside its bound (the least time the card could
     take: bytes over the memory rate against operations over the peak
     rate, the larger of the two);
  2b. the sedimentation kernel (csrc/sed.cu) against its plain version at
     the main path's shapes in float32 (btz96.ens64's and multiphase.ens8's
     sedp, ens8's sedl with its 8 splits): bit-equal, both timed with CUDA
     events, the kernel beside its bound;
  3. main path: the BTZ96 minute step (mic=T, chem=F, PIFM2 radiation on)
     at the production grid in float32 for 64 columns, three minutes, with
     the kernels' launch counters read around them; then the radiation
     call alone (host clock around synchronised calls, launches per call
     from torch.profiler) and one minute under torch.profiler, with its
     device time by kernel (key_averages); then both Bott kernels timed on
     the rows of one more minute's first launches;
  4. the same port on the card (kernels) against the port on the CPU
     (plain versions): two columns, one at 00:00 and one at 12:00,
     float64, one minute, radiation fields included;
  4b. radiation alone: nstrahl on the card against the CPU at the
     production nrlay, a noon and a midnight column, float64 and float32;
  5. the batched-inverse kernel against its plain torch version on the
     card, float64 and float32, at the stiff chemistry solve's shapes for
     2048 cells ([8192, 80, 80] aqueous blocks, [2048, 101, 101] Schur
     complements): equilibrated stage matrices of the tot-shaped
     mechanism, a diagonally dominant batch and a batch that needs
     pivoting; prints each shape's launch plan (variant, tile, grid, and
     the blocks per SM from cudaOccupancyMaxActiveBlocksPerMultiprocessor),
     checks it against the Python plan and says whether the kernel is
     equal to the plain version bit for bit; times both and
     torch.linalg.inv beside them, and sets each time beside its bound;
  6. chemistry path: GasKernel.integrate (Ros3, block-arrow solver) for
     2048 cells in float64, one warm 10-s substep and timed substeps, with
     the inverse kernel's launch counter read around them, then one more
     substep under torch.profiler with its device time by kernel;
     Phase 5 also holds the inverse at the chem=T minute's shapes and dtypes
     (phase 8): the gas mechanism's 2 bins of m = 4 and its gas core of
     m = 95, one cell per interior layer of 64 columns, float32 and
     float64;
  7. the chemistry path on the card against the CPU: 16 cells, float64,
     one substep;
  8. chem=T minute: the BTZ96 settings with chem=True, nkc_l=0 (the
     entry's chemistry configuration, __graft_entry__.py:25-33) at the
     production grid in float32 for 64 columns, half at 00:00 and half at
     12:00, two minutes (the J-rates held on the odd minute, recomputed on
     the even one), with every kernel's launch counter read around them;
     the photolysis call alone; one more minute under torch.profiler;
  9. the chem=T port on the card against the port on the CPU: two columns
     (00:00, 12:00), float64, two minutes, the chemistry fields included,
     at the production grid cut in depth (nf=50, n_extra=25, nka=nkt=70,
     the inversion at 400 m: the CPU side took 257 s at full depth on a
     slow host); then photolysis alone, card against CPU, float64 and
     float32;
 10. multiphase minute: the settings of benchmarks/smoke_tot_full.py:51-54
     (BTZ96 with chem=True, nkc_l=4, halo=True, iod=False; float32 state,
     the tot solve in float64) at the production grid for 4 columns, half
     at 00:00 and half at 12:00, two minutes with every kernel's launch
     counter read around them; liq_parm alone; the inverse at the path's
     own shapes and dtypes (the tot solve's aqueous blocks and gas core in
     float64, the gas-above solve's in float32, each the input of the
     path's first launch), bit-equal to the plain version and timed beside
     it, torch.linalg.inv and its bound; one more minute under
     torch.profiler, whose first dwsum and advect inputs hold both Bott
     kernels against their plain versions, timed beside their bounds;
 11. the multiphase port on the card against the port on the CPU: a noon
     and a midnight column, float64, two minutes, at the tiny grid of the
     tests (nf=20, n_extra=10, nka=nkt=16, the inversion at 100 m) with the
     small tot stand-in (12 gas species, 25 aqueous stems): the production
     grid's tot solve would take the CPU ~10 s per column and substep;
 12. nucleation column: phase 8's settings with nuc=True, napari and
     lovejoy both on (appnucl2) and ifeed=1, 64 columns half at noon,
     float32, two minutes, every kernel's launches counted; the fields
     finite and nucleation adding particles in at least one column; the
     steady minute beside phase 8's; one more minute under
     torch.profiler (as each path of phases 13-14);
 13. box and chamber: 64 boxes of the box of tests/test_boxmodel.py:18-20
     with the multiphase driver (nkc_l=4: integrate_box's tot solve at
     the box level), two minutes, and the inverse at the box's own
     first-launch shapes, bit-equal to the plain version and timed beside
     it, torch.linalg.inv and its bound; 64 chambers of the Buxmann15_alpha
     settings of tests/test_buxmann.py:65-71 (mic=F, nkc_l=0, halo, no
     iodine) on chamber.dat, the clock at 13 min: the J-rates zero after
     the first minute and the measured ones after the second, at 15 min;
     float32, launches counted;
 14. bare soil (isurf=1): BTZ96 with mic=F and chem=T (the gas-phase
     driver), then with mic=T and chem=F (both Bott kernels), 64 columns
     half at noon, float32, two minutes each; the soil's tb and eb moved
     and stayed finite;
 15. each path of phases 12-14 on the card against the CPU, and
     nucleation with the multiphase driver at the configuration's defaults
     (nkc_l=4, napari and lovejoy, ifeed=0): two columns (a midnight and a
     noon column; chambers across the lights' edge), float64, two minutes,
     the tiny grid of phase 11 with the small tot stand-in and a small gas
     stand-in that holds OIO (45 gas species);
 16. the run harness: python -m mistra_tpu_torch in a subprocess of this
     script, one column at the production grid, each run started from a
     checkpoint of its namelist's initial state with the clock's minute
     set: (a) BTZ96 in float32 from 11:31 for 31 minutes (the initial
     record with the 2-D spectrum, the 15-minute snapshot, the 12:00
     profiles and checkpoint, the 30-minute snapshot with the 2-D
     spectrum, the first one timed in a warm run); (b) 2 minutes from
     (a)'s 12:00 checkpoint,
     within 1e-6 of (a)'s end (and whether bit-equal); (c) the multiphase
     settings of phase 10 with binout from 11:59 for 2 minutes (mass.out,
     profc.out, the chemistry output, the budgets defined); (d) (a)'s
     settings for 4 minutes with --profile, whose trace must hold
     bott_dwsum_kernel events.  Every output file present and finite;
     each run's kernel launches as the CLI counts them (dwsum, advect and
     sedp's sedimentation kernel in (a), all five in (c)), its seconds
     per minute and host ms per snapshot (the initial record, with its
     first-call set-up; with the 2-D spectrum ff; without) and per
     checkpoint, the writer it took and whether the host has libnetcdf;
 17. the tp split: ff's dry-aerosol axis over TP = 2 ranks, spawned
     processes joined by torch.distributed (nccl with a card each where
     the host has two cards, else gloo with both ranks on cuda:0; the
     log says which): (a) BTZ96 and (b) chem=T at the production grid,
     float32, 8 columns (half at noon for chem=T), two minutes, each
     rank's launches (dwsum equal to a tp=1 run's on the same state,
     advect once per substep, the inverse on every rank), all_reduce
     calls and host ms per minute and minute time beside the tp=1 run's;
     (c) a noon and a midnight column in float64, one minute, shared out
     from tp=1's start state, gathered and held against tp=1 at phase
     4's tolerances; (d) the multiphase minute of phase 10 (float32
     state, float64 tot solve) for 4 columns, half at noon, two minutes
     at tp=2 beside phase 10's tp=1 run, each rank's launches as (a)'s
     and (b)'s (dwsum within one Newton iteration per substep), its
     all_reduce calls, bytes and host ms per minute (the mass feedback
     brings its targets home with one all_reduce of the whole dry axis
     per chemistry bin) and its minute beside tp=1's; (e) as (c) on the
     tiny grid of phases 11 and 15 with their small stand-ins, for the
     multiphase minute, nucleation with the gas-phase and with the
     multiphase driver (ifeed=1), the box and the chamber, each
     concentration row held to its species' scale; the replicated
     fields bit-equal across the ranks (gather_state checks them in
     every run).  A rank that fails or outlives its deadline fails the
     script.

The input tables of phases 3-4b and 8-9 are the reference's where $INPDIR
holds them (clarke.dat; pifm2_171115.dat with the six Mie files;
photolys/flux.dat, sig0900.dat, cheb_coeff.dat, qyield.dat), else
synthetic stand-ins (write_synthetic_clarke_table,
write_synthetic_radiation_tables, write_synthetic_photolysis_tables; not
the reference's values).  The mechanism of phases 5-7 is the reference's
tot mechanism when $MECHDIR holds master_gas.eqn and master_aqueous.eqn,
else a synthetic stand-in of its block shape
(mistra_tpu_torch.chemistry.mech.write_synthetic_multiphase_mechanism; not
the reference's chemistry).  The gas mechanism of phases 5 and 8-9 is the
reference's when $MECHDIR holds gas.eqn, master_gas.eqn and
gas_species.csv, else a synthetic stand-in of its shape
(write_synthetic_gas_mechanism: 95 gas species and 7 binned, 331
reactions; not the reference's chemistry).  The tot mechanism of phase 10
is the reference's when $MECHDIR holds those three files and
master_aqueous.eqn, tot_eqn12.head and tot_eqn34.head, else a synthetic
stand-in of its shape (write_synthetic_tot_mechanism: nvar 410, bins of
80/79/78/78, a gas core of 95, ~1,590 reactions; not the reference's
chemistry); phase 11 always takes the small stand-in.  Phases 12-14 take
the gas and tot mechanisms of phases 8 and 10; chamber.dat is $INPDIR's
(photolys/chamber.dat) where it holds one, else a synthetic stand-in
(mistra_tpu_torch.boxmodel.write_synthetic_chamber_dat; not the
reference's measurements).

In every minute run of phases 3, 8, 10 and 12-14, in (d) and in each tp
rank of phase 17, the sedimentation kernel's launches are held to one per
pass of sedp's Courant loop (its host checks, ``sync.sedp``, less one per
call) and one per sedl call, at least one per substep on a path with
mic=T and one sedl call per substep on a path with the multiphase driver.

The last two lines are a JSON object of per-kernel results and the
device line {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# BTZ96 radiation-fog configuration of the flagship entry point
BTZ96 = dict(chem=False, mic=True, tw=288.15, zinv=800.0, dtinv=7.0, ug=8.5,
             vg=0.0, nw_prof_opt=1, wmax=-0.005, z0=0.0001, alat=55.0)
MAIN_COLUMNS = 64
MAIN_MINUTES = 3
CMP_COLUMNS = 4
DT = 10.0
RAD_REPS = 5
# the model grid of phases 3-4b: None is GridParams(), the production grid
GRID = None

# kernel against plain, on one card, same inputs.  The kernels do the plain
# version's arithmetic expression by expression (no contracted multiply-
# adds); what differs is the order of the row reductions.  The error is
# taken relative to the row's largest bin (advect) or, for dwsum, a
# difference of gained and lost water mass, to the sum of the magnitudes
# it is made of, sum_k (|psi_k| + |z_k|) e_k.
KERNEL_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
# advect conserves each row's mass of significant bins
MASS_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
# card against CPU, two columns, float64, one minute: relative to each
# field's largest magnitude.  Libm and reduction order differ between the
# devices; a flip of one Newton convergence test (|res| < 1e-6) moves the
# mean saturation by ~1e-6, which bounds what t, xm1 and ff can move by.
# The radiation call after the minute sees those states: t moved by 1e-6
# moves the Planck fluxes (T^4) by 4e-6, hence sk, sl and the band sums of
# totrad; the heating rate, a layer difference of net fluxes ~400x its
# size, by up to ~2e-3 of its scale.
DEVICE_TOL = {"t": 1e-6, "xm1": 1e-6, "ff": 1e-5, "dtrad": 2e-3,
              "totrad": 1e-4, "sk": 1e-5, "sl": 1e-5}
# nstrahl alone, card against CPU on the same inputs, relative to each
# output's largest magnitude.  float64: libm differs by ulps, which the
# heating rate's difference of fluxes (~400x) and the cancelling a6 of
# the IR coefficients (~1e-6 relative at dtau ~1e-7) lift to <= ~1e-10.
# float32: the solve's own float32 error against float64 on the same
# inputs (tiny grid, CPU) is hr 3.2e-4, totrad 1.5e-3, fnseb 5.5e-7,
# flgeg 1.3e-3 of the scale (cancellations such as the a6 above, in
# float32); two devices' float32 results differ by up to about as much
RAD_TOL = {torch.float64: {"hr": 1e-9, "totrad": 1e-9, "fnseb": 1e-9,
                           "flgeg": 1e-9},
           torch.float32: {"hr": 3e-3, "totrad": 3e-3, "fnseb": 1e-4,
                           "flgeg": 3e-3}}

# the card's peak rates for bound_ms (H100 SXM data sheet, at 700 W): HBM
# bytes per second; operations per second of float32 outside the tensor
# cores, and of float64 at the tensor cores' rate (DMMA), its highest
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 67e12}
# operations of the Bott kernels: a divide and an add per bin and
# direction for the prefix sums, and about 100 per significant source bin
# for the searched walk (~30) and the order-4 Bott split (~70); the
# deposit's few compares and adds per bin are left out (a lower bound)
BOTT_SCAN_OPS_PER_BIN = 4
BOTT_OPS_PER_SOURCE = 100
# the sedimentation kernel (phase 2b): ~75 operations per level of a row's
# Bott walk; the main path's shapes (what, columns, sedl's splits or not)
# at nf = 100 in float32, sedl's rows 315 aqueous species per column (the
# tot mechanism's 4 bins)
SED_OPS_PER_LEVEL = 75
SED_NF = 100
SED_SEDL_ROWS = 315
SED_CASES = (("btz96.ens64 sedp", 64, False),
             ("multiphase.ens8 sedp", 8, False),
             ("multiphase.ens8 sedl", 8, True))

# stiff chemistry solve (phases 5-7)
DEVICE = "cuda"
CHEM_CELLS = 2048
CHEM_DT = 10.0
CHEM_TIMED = 3
CHEM_CMP_CELLS = 16
# batched inverse, kernel against plain on one card, same inputs: the same
# operations in the same order (no contracted multiply-adds), so they agree
# up to a differing rounding of the two compilers; relative to the largest
# entry of the inverse
LU_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# normwise residual ||A X - I|| / (||A|| ||X||) (infinity norms) of a
# pivoted elimination is a few m * eps: at most 1.8 m eps on the float32
# aqueous stage blocks, 0.2 m eps in float64 (plain version, CPU); the
# bound leaves a margin of ~9
LU_RES_FACTOR = 16
# card against CPU, chemistry path, 16 cells, float64, one 10-s substep:
# relative to each species' largest |y| over the cells.  Both runs hold
# every step's local error under rtol = 1e-3 of |y|; runs that differ only
# by rounding agree far closer while they take the same steps, and stay
# within ~rtol of each other where an accept/reject decision flips
CHEM_DEVICE_TOL = 1e-3

# chem=T minute (phases 8-9): the entry's chemistry configuration
CHEM_T = dict(BTZ96, chem=True, nkc_l=0)
CHEM_T_COLUMNS = 64
CHEM_T_MINUTES = 2
PHOT_REPS = 3
# card against CPU, chem=T, two columns, float64, two minutes.  t, xm1
# and ff as DEVICE_TOL (the same physics).  sgas, relative to each
# species' largest value: while both runs take the same Ros3 steps they
# agree to rounding; where an accept/reject decision flips, the two
# trajectories each hold their local error under rtol = 1e-3, so the
# runs can part by up to ~rtol per substep that flips, 12 substeps in two
# minutes: 1e-2.  photol_j, relative to each slot's largest value: the
# J-rates of minute 2 are computed from states that differ by ~1e-6 in t
# and ~1e-5 in ff (the aerosol optics), a smooth map: 1e-4
# phase 9's grid: the production grid's widths (nka, nkt, the bands and
# species) at half its depth, the inversion at half its height, inside the
# cut grid's constant-dz layers
CHEM_T_CMP_GRID = dict(nf=50, n_extra=25)
CHEM_T_CMP_ZINV = 400.0
CHEM_T_DEVICE_TOL = {"t": 1e-6, "xm1": 1e-6, "ff": 1e-5, "sgas": 1e-2,
                     "photol_j": 1e-4}
# multiphase minute (phases 10-11): the settings of
# benchmarks/smoke_tot_full.py:51-54; the state in float32 and, by
# chem_f64's default, the tot solve in float64
MULTIPHASE = dict(BTZ96, chem=True, nkc_l=4, halo=True, iod=False)
# 4: with 64 the whole script took 990.8 s of command time on an H100
# 80GB HBM3 at 700 W, the multiphase minute being device-bound (84 % busy:
# 32 columns take about half its time); with 32 it took 927.7 s, and the
# run harness (phase 16) takes ~105 s more; with 16 the script took 947.1 s
# before phase 17 (d), whose tp=1 run is this phase's; with 8 (a steady
# minute of 11.6 s at tp=1, 19.9 s on each tp=2 rank) it took 1,027.3 s,
# phase 10 180.8 s of it (mostly the profiled minute's 693,440 events)
MP_COLUMNS = 4
MP_MINUTES = 2
LIQ_PARM_REPS = 3
# the reference's tot mechanism files, which $MECHDIR may hold
TOT_FILES = ("gas.eqn", "master_gas.eqn", "gas_species.csv",
             "master_aqueous.eqn", "tot_eqn12.head", "tot_eqn34.head")
# phase 11: the tests' tiny grid (its inversion inside the grid) and small
# tot stand-in (gas species, aqueous stems)
MP_CMP_GRID = dict(nf=20, n_extra=10, nka=16, nkt=16, nb=8)
MP_CMP_MECH = (12, 25)
# card against CPU, multiphase, two columns, float64, two minutes: t, xm1,
# ff and photol_j as CHEM_T_DEVICE_TOL; conc, relative to each species'
# largest value, as sgas there: the runs agree to rounding while their
# Ros3 decisions agree, and part by up to ~rtol = 1e-3 per substep where
# one flips, 12 substeps: 1e-2
MP_DEVICE_TOL = {"t": 1e-6, "xm1": 1e-6, "ff": 1e-5, "conc": 1e-2,
                 "photol_j": 1e-4}
# photolysis alone, card against CPU on the same inputs, relative to each
# slot's largest value.  The calculation runs in float64 for every model
# dtype; libm and summation order differ between the devices by ulps,
# which the four-stream system (condition up to ~1e11 under a fog; the
# block solve is refined to the dense LU's residual) lifts to <= ~1e-10.
# float32: the same float64 calculation on the same float32 inputs, its
# result rounded to float32 (2^-24 ~ 6e-8) on each device: 1e-6
PHOT_TOL = {torch.float64: 1e-9, torch.float32: 1e-6}
# the modes slice (phases 12-15)
# phase 12: the chem=T minute's settings with nucleation, both mechanisms
# (appnucl2) and the feedback into the particles
NUC = dict(CHEM_T, nuc=True, napari=True, lovejoy=True, ifeed=1)
NUC_COLUMNS = 64
MODE_MINUTES = 2
# phase 13: the box of tests/test_boxmodel.py:18-20 with the multiphase
# driver (nkc_l=4, so integrate_box runs the tot solve at the box level)
BOX = dict(MULTIPHASE, box=True, nlevbox=5, z_box=50.0)
# the Buxmann15_alpha chamber of tests/test_buxmann.py:65-71 (its
# mechanism directory aside: the gas stand-in, or $MECHDIR's)
CHAMBER = dict(chamber=True, box=False, chem=True, mic=False, halo=True,
               iod=False, nkc_l=0, zinv=100.0, tw=288.40, rhsurf=0.6,
               ug=7.0, vg=0.0, alat=-75.6, z0=1.0e-5, lp_buxmann15alph=True)
BOX_COLUMNS = 64
# the chambers' clock before their two minutes: the first ends at 14 min
# (lights off), the second at 15 min, where the lights go on
CHAMBER_START_S = 13.0 * 60.0
# phase 14: BTZ96 on bare soil, mic=F with the gas-phase driver (chem=T:
# nkc_l keeps its default 4, the gas-phase driver all the same), and mic=T
# with chemistry off, which runs both Bott kernels
SOIL_MIC_F = dict(BTZ96, isurf=1, mic=False, chem=True)
SOIL = dict(BTZ96, isurf=1)
SOIL_COLUMNS = 64
# phase 15: the tests' tiny grid and small stand-ins (a gas stand-in with
# OIO, the 41st named species, for nucleation's Lovejoy path); nucleation
# with the multiphase driver at the configuration's defaults (napari and
# lovejoy, ifeed=0: without the feedback, whose trace of particles carried
# into bin 3 makes that bin's trace concentrations, 1e-35 to 1e-22
# mol/m3, move by their own size under rounding, as
# tests/test_torch_nucleation_feedback.py sets out)
MODES_CMP_GAS = 45
NUC_MULTIPHASE = dict(MULTIPHASE, nuc=True)
# card against CPU on the new paths, two columns, float64, two minutes:
# t, xm1, ff and the concentrations as MP_DEVICE_TOL; the soil's tb and
# eb as t (the same surface balance on states that differ by ~1e-6)
MODES_DEVICE_TOL = {"t": 1e-6, "xm1": 1e-6, "ff": 1e-5, "tb": 1e-6,
                    "eb": 1e-6, "conc": 1e-2}

# phase 16: the run harness (python -m mistra_tpu_torch) on the card, one
# column at the production grid.  The configuration has no start minute
# (only nhour), so each run starts from a checkpoint of the initial state
# with its clock's minute set (--restart), as a user restarts a run.
# (a) BTZ96 in float32 from 11:31 for 31 minutes: the initial record with
# the 2-D spectrum, the 15-minute snapshot, the 12:00 profiles and
# checkpoint, the 30-minute snapshot with the 2-D spectrum (a snapshot
# with ff in the warm loop: the initial record's time holds the first
# calls' set-up); (b) 2 minutes from (a)'s 12:00 checkpoint, which must end
# where (a) ends, each field within CLI_RESTART_TOL of its scale (the same
# kernels on the same inputs: bit-equal is expected); (c) the multiphase
# chem=T settings (phase 10's) with binout from 11:59 for 2 minutes across
# the hour: mass.out, profc.out, the chemistry output and the budgets
# defined; (d) (a)'s settings for 4 minutes with --profile (minutes 2-4)
CLI_NHOUR = 11
CLI_START_MINUTE = 31
CLI_MINUTES = 31
CLI_RESTART_MINUTES = 2
CLI_CHEM_START_MINUTE = 59
CLI_CHEM_MINUTES = 2
CLI_PROFILE_MINUTES = 4
CLI_RESTART_TOL = 1e-6
CLI_TIMEOUT_S = 600
# --grid of the runs: None is the production grid
CLI_GRID = None

# the tp split (phase 17): ff's dry-aerosol axis over TP ranks, one
# spawned process each; (a) BTZ96 and (b) chem=T at the production grid
# in float32, TP_COLUMNS columns, TP_MINUTES minutes, (c) BTZ96 and
# chem=T, a noon and a midnight column each, in float64 for one minute
# against tp=1 on the same card, (d) the multiphase minute at the
# production grid for MP_COLUMNS columns (its tp=1 run phase 10's), and
# (e) the multiphase minute, nucleation with both drivers, the box and
# the chamber as (c) on the tiny grid of phases 11 and 15
TP = 2
TP_COLUMNS = 8
TP_MINUTES = 2
# (d) in float32: subkon's Newton exit test reads sums over the bins,
# whose order differs between tp=2 and tp=1, and the float32 states part
# by rounding; on the card dwsum launched 93 times against 92 at 8
# columns and 84 against 89 at 4; the ranks' counts stay equal (they stop
# on agreed flags), and tp=1's may differ by one iteration per substep
TP_MP_NEWTON_FLIPS = 6 * TP_MINUTES
# a rank's collectives wait at most this long on the other rank; the
# parent waits at most TP_JOIN_S for both ranks to end
TP_COLLECTIVE_TIMEOUT_S = 120.0
TP_JOIN_S = 480.0
# (c): tp=TP against tp=1 on one card, float64, relative to each field's
# largest magnitude (each row's own for TP_ROWS).  The two
# differ only in the order of the sums over the dry bins (a partial sum
# per rank, then their sum): ~1e-16 per sum, which a minute's Newton
# solves lift to ~1e-11 of the scale (6.4e-12 for fogged columns on the
# CPU, tests/test_torch_mesh_tp.py)
TP_TOL = 1e-10
TP_FIELDS = ("met.t", "met.xm1", "micro.ff", "rad.dtrad", "rad.totrad",
             "rad.sk", "rad.sl")
# the chem=T fields compared per row (species, J slot), each to its own
# largest magnitude
TP_ROWS = ("chem.sgas", "chem.conc", "chem.photol_j")
# (e): the paths and their mechanisms (the small stand-ins of phases 11
# and 15); nucleation with the multiphase driver with the feedback of
# its particles (ifeed=1) for one minute, where rounding moves no trace
# (phase 15's two minutes run ifeed=0)
TP_PATHS = {"multiphase": ("tot", MULTIPHASE),
            "nucleation": ("gas", NUC),
            "nucleation nkc_l=4": ("tot", dict(NUC_MULTIPHASE, ifeed=1)),
            "box": ("tot", BOX), "chamber": ("gas", CHAMBER)}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg) -> None:
    """Fail the run (an assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(label, fn, *args):
    """fn(*args), logging its host-clock time under label."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"{label}: {time.perf_counter() - t0:.1f} s")
    return out


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around reps calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bott_inputs(rows: int, nkt: int, dtype, seed: int):
    """Mixed-sign velocities with zeros, fast rows (|u| >> 1, walks beyond
    the band) and slow rows; sparse positive spectra with sub-YMIN bins."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-3.0, 3.0, (rows, nkt))
    u[rng.uniform(size=u.shape) < 0.15] = 0.0
    fast = rng.uniform(size=rows) < 0.05
    u[fast] = rng.choice([-1.0, 1.0], (int(fast.sum()), 1)) \
        * rng.uniform(5.0, 40.0, (int(fast.sum()), nkt))
    slow = rng.uniform(size=rows) < 0.05
    u[slow] *= 1e-6
    z = rng.lognormal(0.0, 2.0, (rows, nkt))
    z[rng.uniform(size=z.shape) < 0.3] = 0.0
    z[rng.uniform(size=z.shape) < 0.02] = 1e-35
    e = np.exp(np.linspace(-20.0, 8.0, nkt))
    dev = torch.device("cuda")
    return (torch.tensor(u, dtype=dtype, device=dev),
            torch.tensor(z, dtype=dtype, device=dev),
            torch.tensor(e, dtype=dtype, device=dev))


def bound(nbytes: float, ops: float, dtype) -> dict:
    """bound_ms (the larger of bytes over the memory rate and operations
    over the dtype's peak rate) and what bounds it."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / PEAK_OPS_PER_S[dtype]
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def bott_bounds(u, z) -> dict:
    """bound of each Bott kernel on these inputs: advect reads u, z and
    writes psi; dwsum reads u, z and e and writes one value per row."""
    rows, nkt = z.shape
    elt = z.element_size()
    ops = (BOTT_SCAN_OPS_PER_BIN * z.numel()
           + BOTT_OPS_PER_SOURCE * int((z >= 1e-32).sum()))
    return {"bott_advect": bound(3 * z.numel() * elt, ops, z.dtype),
            "bott_dwsum": bound((2 * z.numel() + nkt + rows) * elt, ops,
                                z.dtype)}


def dwsum_scale(psi, z, e):
    """Per-row magnitude of the terms of dwsum: sum_k (|psi_k|+|z_k|) e_k."""
    return ((psi.abs() + z.abs()) * e).sum(dim=1).clamp(min=1e-300)


def compare_bott(growth, bott_cuda, dt, dw, adv, e, J, plain_reps, what=""):
    """Both kernels against their plain versions on the card: dwsum on
    dw = (u, z) and advect on adv = (u, z), rows x nkt each, e [nkt];
    checks agreement and advect's mass, times both (CUDA events) and
    returns each kernel's result fields."""
    u, z = adv
    zmax = z.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)
    psi_k = bott_cuda.bott_advect(dt, u, z, J)
    psi_p = growth.bott_advect_plain(dt, u, z, J)
    rel_a = ((psi_k - psi_p).abs() / zmax).max().item()
    sig = torch.where(z >= growth.YMIN, z, 0.0).sum(dim=1)
    mass = ((psi_k.sum(dim=1) - sig).abs()
            / sig.clamp(min=1e-300)).max().item()
    dtype = z.dtype
    tol = KERNEL_TOL[dtype]

    def shape(z):
        return (f"{z.shape[0]}x{z.shape[1]} "
                f"{str(z.dtype).replace('torch.', '')} J={J}")

    out = {"bott_advect": dict(
        max_abs_err=(psi_k - psi_p).abs().max().item(), rel_err=rel_a,
        tol=tol, shape=shape(z),
        ms=cuda_ms(lambda: bott_cuda.bott_advect(dt, u, z, J), 20),
        plain_ms=cuda_ms(lambda: growth.bott_advect_plain(dt, u, z, J),
                         plain_reps),
        library_ms=None, **bott_bounds(u, z)["bott_advect"])}

    u, z = dw
    if dw is not adv:
        psi_p = growth.bott_advect_plain(dt, u, z, J)
    dw_k = bott_cuda.bott_dwsum(dt, u, z, e, J)
    dw_p = growth.bott_dwsum_plain(dt, u, z, e, J)
    rel_d = ((dw_k - dw_p).abs() / dwsum_scale(psi_p, z, e)).max().item()
    out["bott_dwsum"] = dict(
        max_abs_err=(dw_k - dw_p).abs().max().item(), rel_err=rel_d,
        tol=tol, shape=shape(z),
        ms=cuda_ms(lambda: bott_cuda.bott_dwsum(dt, u, z, e, J), 20),
        plain_ms=cuda_ms(lambda: growth.bott_dwsum_plain(dt, u, z, e, J),
                         plain_reps),
        library_ms=None, **bott_bounds(u, z)["bott_dwsum"])
    for r in out.values():
        r["roofline_share"] = r["bound_ms"] / r["ms"]
    log(f"kernels{what}: " + "; ".join(
        f"{k} {r['shape']} err {r['max_abs_err']:.3e} (rel "
        f"{r['rel_err']:.3e}) {r['ms'] * 1e3:.1f} us vs plain "
        f"{r['plain_ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.1f} us "
        f"({r['bound_by']}, {100.0 * r['roofline_share']:.1f} %)"
        for k, r in out.items()) + f"; advect mass {mass:.3e}")
    check(rel_a <= tol, f"advect{what} disagrees: {rel_a} > {tol}")
    check(rel_d <= tol, f"dwsum{what} disagrees: {rel_d} > {tol}")
    check(mass <= MASS_TOL[dtype], f"advect{what} mass error {mass}")
    return out


def compare_kernels(growth, bott_cuda, rows, dtype, J, seed, plain_reps):
    """compare_bott on one random input of rows x 70 bins."""
    u, z, e = bott_inputs(rows, 70, dtype, seed)
    return compare_bott(growth, bott_cuda, DT, (u, z), (u, z), e, J,
                        plain_reps)


def phase_kernels(growth, bott_cuda):
    """Kernel against plain on the card, at each dtype and band for a few
    columns, then at the main path's shape, dtype and band (64 columns,
    float32, J = 32), whose fields go into the JSON line."""
    for dtype in (torch.float64, torch.float32):
        for J in (32, 70):
            compare_kernels(growth, bott_cuda, CMP_COLUMNS * 100 * 70, dtype,
                            J, seed=J, plain_reps=5)
    return compare_kernels(growth, bott_cuda, MAIN_COLUMNS * 100 * 70,
                           torch.float32, growth.BAND, seed=1, plain_reps=3)


def sed_inputs(columns: int, nsplit: int, seed: int):
    """The sedimentation kernel's inputs at a main-path shape, float32 on
    the card, nf = SED_NF.  sedp (nsplit 0): columns x 70 x 70 rows of
    psi, lognormal with empty bins, Courant numbers in [-1, 0], the
    upstream form where the production grid's rq < 1 um.  sedl: columns x
    SED_SEDL_ROWS rows, Courant numbers per second of 1e-5..0.1 (one split
    of 10 s, as the main path's droplets take), dt0 10 s."""
    from mistra_tpu_torch import MistraConfig
    from mistra_tpu_torch.grids import make_grids
    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    rows = columns * (SED_SEDL_ROWS if nsplit else 70 * 70)
    psi = rng.lognormal(0.0, 2.0, (rows, SED_NF))
    psi[rng.uniform(size=rows) < 0.3] = 0.0

    def as_t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    if nsplit:
        c = -rng.uniform(0.0, 1.0, (rows, SED_NF)) \
            * 10.0 ** rng.uniform(-5.0, -1.0, (rows, 1))
        c[:, -1] = 0.0
        c = as_t(c)
        xxxt = -0.999 / c[:, 1]
        return c, as_t(psi), xxxt, torch.full_like(xxxt, DT)
    up = make_grids(MistraConfig()).micro.rq < 1.0
    up = torch.tensor(np.broadcast_to(up, (columns, 70, 70)).reshape(rows),
                      device=dev)
    return as_t(-rng.uniform(0.0, 1.0, (rows, SED_NF))), as_t(psi), up


def phase_sed():
    """The sedimentation kernel (csrc/sed.cu) against its plain version at
    the main path's shapes (SED_CASES, float32): bit-equal, kernel and
    plain ms by CUDA events, the bound (bytes: c and psi read, psi written
    once; per-row values besides) and launches per call."""
    from mistra_tpu_torch.chemistry.driver_aq import SEDL_SPLITS
    from mistra_tpu_torch.physics import sed_cuda
    from mistra_tpu_torch.physics import sedimentation as sed
    out = {}
    for i, (what, columns, splits) in enumerate(SED_CASES):
        nsplit = SEDL_SPLITS if splits else 0
        args = sed_inputs(columns, nsplit, seed=i)
        if nsplit:
            c, psi, xxxt, dt0 = args
            kernel = lambda: sed_cuda.advsed_splits(c, psi, xxxt, dt0,
                                                    nsplit)
            plain = lambda: sed.advsed1_splits_plain(c, psi, xxxt, dt0,
                                                     nsplit)
            left, walks = dt0.clone(), 0
            for _ in range(nsplit):
                act = left > 0.1
                walks += int(act.sum())
                left = torch.where(act, left - torch.minimum(left, xxxt),
                                   left)
            extra = 3 * psi.shape[0] * psi.element_size()
        else:
            c, psi, up = args
            kernel = lambda: sed_cuda.advsed(c, psi, up)
            plain = lambda: torch.where(up[:, None], sed.advsed0(c, psi),
                                        sed.advsed1(c, psi))
            walks, extra = psi.shape[0], up.numel()
        # psi (and sedl's ground deposit), bit for bit
        pairs = zip(*(r if nsplit else (r,) for r in (kernel(), plain())))
        bit_equal = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                        for g, w in pairs)
        check(bit_equal, f"sed kernel differs from plain ({what})")
        sed_cuda.reset_counts()
        kernel()
        launches = sed_cuda.advsed.launches + sed_cuda.advsed_splits.launches
        ms = cuda_ms(kernel, reps=20)
        plain_ms = cuda_ms(plain, reps=2, warmup=1)
        b = bound(3 * psi.numel() * psi.element_size() + extra,
                  SED_OPS_PER_LEVEL * SED_NF * walks, psi.dtype)
        out[what] = {"shape": f"{psi.shape[0]}x{SED_NF}", "nsplit": nsplit,
                     "walks": walks, "bit_equal": bit_equal, "ms": ms,
                     "plain_ms": plain_ms, "launches_per_call": launches,
                     **b, "roofline_share": b["bound_ms"] / ms}
        log(f"sed {what} [{psi.shape[0]} x {SED_NF}] f32, {walks} row "
            f"walks: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}), share "
            f"{100 * b['bound_ms'] / ms:.1f} %, bit-equal {bit_equal}, "
            f"{launches:g} launch per call")
    return out


def input_dir(tmp: str) -> str:
    """tmp, holding the input tables of the BTZ96 and chem=T steps: links
    to INPDIR's reference tables where it holds them, else the synthetic
    stand-ins (clarke.dat; pifm2_171115.dat with the six Mie files; the
    four photolys/ files)."""
    from mistra_tpu_torch.photolysis.tables import (
        PHOTOLYSIS_FILES, write_synthetic_photolysis_tables)
    from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
    from mistra_tpu_torch.radiation.tables import (
        MIE_FILES, PIFM2_FILE, write_synthetic_radiation_tables)
    inpdir = os.environ.get("INPDIR")
    phot = tuple(os.path.join("photolys", f) for f in PHOTOLYSIS_FILES)
    for label, files, write in (
            ("clarke.dat", ("clarke.dat",), write_synthetic_clarke_table),
            ("radiation tables", (PIFM2_FILE,) + MIE_FILES,
             write_synthetic_radiation_tables),
            ("photolysis tables", phot, write_synthetic_photolysis_tables)):
        if inpdir and all(os.path.exists(os.path.join(inpdir, f))
                          for f in files):
            for f in files:
                os.makedirs(os.path.dirname(os.path.join(tmp, f)),
                            exist_ok=True)
                os.symlink(os.path.abspath(os.path.join(inpdir, f)),
                           os.path.join(tmp, f))
            log(f"{label}: reference tables from INPDIR ({inpdir})")
        else:
            write(tmp)
            log(f"{label}: synthetic stand-in (INPDIR lacks "
                f"{', '.join(files)})")
    return tmp


def gas_mechanism_dir(tmp: str):
    """(directory, is_reference) of the chem=T minute's gas mechanism:
    $MECHDIR when it holds the reference's gas.eqn, master_gas.eqn and
    gas_species.csv, else tmp with the synthetic stand-in written to it."""
    from mistra_tpu_torch.chemistry.mech import write_synthetic_gas_mechanism
    mechdir = os.environ.get("MECHDIR")
    files = ("gas.eqn", "master_gas.eqn", "gas_species.csv")
    if mechdir and all(os.path.exists(os.path.join(mechdir, f))
                       for f in files):
        log(f"gas mechanism: reference gas mechanism from MECHDIR "
            f"({mechdir})")
        return mechdir, True
    write_synthetic_gas_mechanism(tmp)
    log("gas mechanism: synthetic stand-in of the reference's shape "
        f"(MECHDIR lacks {', '.join(files)})")
    return tmp, False


def model_config(inpdir, dtype):
    from mistra_tpu_torch import GridParams, MistraConfig
    return MistraConfig(grid=GRID or GridParams(), dtype=dtype,
                        inpdir=inpdir, **BTZ96)


def count_launches(fn):
    """(device events, aten ops) of one fn(): the kernels and copies the
    card ran, from torch.profiler (None if it recorded no device events),
    and the operators the host dispatched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = sum(1 for e in events if e.device_type == DeviceType.CUDA)
    ops = sum(1 for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith("aten::"))
    return (dev or None), ops


def device_time_by_kernel(prof, top: int = 10) -> list:
    """[(kernel, launches, device ms)] of the top kernels by device time
    in prof, from key_averages."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.count, e.self_device_time_total * 1e-3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])[:top]


def profile_call(fn):
    """fn() under torch.profiler: (its result, wall s, device busy s,
    device events, top kernels by device time); busy is the union of the
    kernels' intervals.  Only the device's activity is recorded: with the
    host's operators too, the profiler parsed the multiphase minute's
    events ~130 s longer."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(spans, "torch.profiler recorded no device event")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return result, wall, busy * 1e-6, len(spans), device_time_by_kernel(prof)


def log_profile(what, wall, busy, events, top):
    log(f"{what} under torch.profiler: wall {1e3 * wall:.1f} ms, device "
        f"busy {1e3 * busy:.1f} ms ({100.0 * busy / wall:.1f} %), {events} "
        f"device events; device time by kernel (key_averages):")
    for name, calls, kms in top:
        log(f"  {kms:9.3f} ms {100.0 * kms / (1e3 * busy):5.1f} % of busy "
            f"{100.0 * kms / (1e3 * wall):5.1f} % of wall  {calls:6d} x "
            f"{name[:90]}")


@contextlib.contextmanager
def keeping_bott_inputs(growth):
    """While open, the dict it yields gains the inputs of the first
    dwsum ("dwsum": dt, u, z, e, band) and advect ("advect": dt, u, z,
    band) launches of the physics, rows x nkt each."""
    kept = {}
    dwsum, advect = growth.bott_dwsum, growth.bott_bin_advection

    def flat(x):
        return x.reshape(-1, x.shape[-1]).clone()

    def keep_dwsum(dt, u, z, e, band=growth.BAND):
        if "dwsum" not in kept:
            kept["dwsum"] = (dt, flat(u), flat(z), e, band)
        return dwsum(dt, u, z, e, band)

    def keep_advect(dt, u, z, band=growth.BAND):
        if "advect" not in kept:
            kept["advect"] = (dt, flat(u), flat(z), band)
        return advect(dt, u, z, band)

    growth.bott_dwsum, growth.bott_bin_advection = keep_dwsum, keep_advect
    try:
        yield kept
    finally:
        growth.bott_dwsum, growth.bott_bin_advection = dwsum, advect


def main_path_rows(model, state, growth, bott_cuda):
    """One more minute step, keeping the inputs of its first dwsum and
    advect launches: what the main path's rows look like (significant
    bins, walk directions, the deposit's reach) and both kernels' time on
    them, with dwsum on the same rows emptied (no significant bin: loads
    and reduction only) as the floor of its time."""
    with keeping_bott_inputs(growth) as kept:
        model.minute_step(state)
    dt, u, z, e, J = kept["dwsum"]
    nkt = z.shape[-1]
    sig = z >= growth.YMIN
    k_low, k_high, _, _ = growth._bott_split(dt, u, z, J)
    i = torch.arange(nkt, device=z.device)
    reach = torch.where(sig, torch.maximum((k_low - i).abs(),
                                           (k_high - i).abs()), 0).amax(1)
    both = (sig & (u > 0)).any(1) & (sig & (u < 0)).any(1)
    dt_a, u_a, z_a, J_a = kept["advect"]
    out = {"rows": z.shape[0],
           "rows_with_significant_bin": sig.any(1).float().mean().item(),
           "significant_bins_per_row": sig.sum(1).float().mean().item(),
           "rows_walking_both_ways": both.float().mean().item(),
           "mean_reach": reach.float().mean().item(),
           "dwsum_ms": cuda_ms(
               lambda: bott_cuda.bott_dwsum(dt, u, z, e, J), 20),
           "dwsum_empty_rows_ms": cuda_ms(
               lambda: bott_cuda.bott_dwsum(dt, u, torch.zeros_like(z), e,
                                            J), 20),
           "advect_ms": cuda_ms(
               lambda: bott_cuda.bott_advect(dt_a, u_a, z_a, J_a), 20)}
    log(f"main-path rows ({out['rows']} rows of {nkt} bins, float32): "
        f"{100.0 * out['rows_with_significant_bin']:.1f} % with a "
        f"significant bin, {out['significant_bins_per_row']:.2f} "
        f"significant bins per row, "
        f"{100.0 * out['rows_walking_both_ways']:.1f} % walking both ways, "
        f"mean reach {out['mean_reach']:.2f} bins; dwsum "
        f"{out['dwsum_ms']:.4f} ms (the same rows emptied "
        f"{out['dwsum_empty_rows_ms']:.4f} ms), advect "
        f"{out['advect_ms']:.4f} ms")
    return out


def phase_main(inpdir, bott_cuda):
    """The BTZ96 minute step on the card; returns the launch counts (the
    sedimentation kernel's held to sedp's passes)."""
    from mistra_tpu_torch import Model
    cfg = model_config(inpdir, "float32")
    model = Model(cfg, device=DEVICE)
    state = model.init_state(MAIN_COLUMNS)
    check(model._radiation is not None, "no radiation driver")
    torch.cuda.synchronize()
    t_start = state.tim.time.clone()

    bott_cuda.reset_counts()
    times = []
    with sed_calls() as seen:
        for _ in range(MAIN_MINUTES):
            t0 = time.perf_counter()
            state = model.minute_step(state)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    counts = {"bott_dwsum": bott_cuda.bott_dwsum.launches,
              "bott_advect": bott_cuda.bott_advect.launches,
              **sed_counts(seen, "main path")}

    gp = cfg.grid
    check_state(state, "main path")
    shape = tuple(state.micro.ff.shape)
    check(shape == (MAIN_COLUMNS, gp.nkt, gp.nka, gp.n), f"ff shape {shape}")
    advanced = (state.tim.time - t_start).cpu().numpy()
    check(np.all(advanced == 60.0 * MAIN_MINUTES), f"clock {advanced}")
    check(bool((state.tim.lmin == MAIN_MINUTES).all()), "minute counter")
    # every substep runs at least one Newton iteration and one replay
    check(counts["bott_dwsum"] >= 6 * MAIN_MINUTES, f"launches {counts}")
    check(counts["bott_advect"] == 6 * MAIN_MINUTES, f"launches {counts}")
    # sedp: one launch per pass, at least one pass per substep; no sedl
    check(counts["sed_advect"] >= 6 * MAIN_MINUTES
          and counts["sed_splits"] == 0, f"launches {counts}")

    check(bool((state.rad.dtrad != 0).any()), "radiation left dtrad zero")

    steady = times[1:] if len(times) > 1 else times
    ms = 1e3 * sum(steady) / len(steady)
    log(f"main path: {MAIN_COLUMNS} columns x {MAIN_MINUTES} minutes, "
        f"float32, grid n={gp.n} nka={gp.nka} nkt={gp.nkt}, radiation on; "
        f"minute step {[round(1e3 * t, 1) for t in times]} ms, steady "
        f"{ms:.1f} ms = {MAIN_COLUMNS / (ms / 1e3):.2f} column-minutes/s; "
        f"launches {counts}; max xm2 {state.met.xm2.max().item():.3e} "
        f"kg/m3; dtrad range [{state.rad.dtrad.min().item() * 86400:.3f}, "
        f"{state.rad.dtrad.max().item() * 86400:.3f}] K/day")

    # the radiation call alone, as post_minute makes it
    rad = model._radiation
    rad_s = []
    for _ in range(RAD_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rad(state)
        torch.cuda.synchronize()
        rad_s.append(time.perf_counter() - t0)
    dev_events, ops = count_launches(lambda: rad(state))
    rad_ms = 1e3 * sum(rad_s) / len(rad_s)
    log(f"radiation call: {MAIN_COLUMNS} columns, float32, nrlay "
        f"{gp.nrlay}; {[round(1e3 * t, 2) for t in rad_s]} ms, mean "
        f"{rad_ms:.2f} ms ({100.0 * rad_ms / ms:.1f} % of the steady minute "
        f"step); per call {dev_events} device events (kernels + copies, "
        f"torch.profiler), {ops} aten ops")
    check(ops > 0, "no operators in the radiation call")

    state, wall, busy, events, top = profile_call(
        lambda: model.minute_step(state))
    log_profile("one minute", wall, busy, events, top)
    from mistra_tpu_torch.physics import growth
    rows = main_path_rows(model, state, growth, bott_cuda)
    return counts, {"radiation_ms": rad_ms, "radiation_device_events":
                    dev_events, "radiation_aten_ops": ops,
                    "minute_ms": ms, "profiled_minute_events": events,
                    "profiled_minute_wall_ms": 1e3 * wall,
                    "profiled_minute_busy_ms": 1e3 * busy,
                    "profiled_minute_top_kernels": [
                        {"kernel": n, "launches": c, "ms": t}
                        for n, c, t in top],
                    "main_path_rows": rows}


def midnight_and_noon(model, B=2, state=None):
    """model's initial state of B columns (or state, B columns of it): the
    first half at 00:00 (the BTZ96 start) and the second half at 12:00
    local solar time, each with its own solar zenith angle and, with
    chemistry on, its own initial J-rates."""
    from mistra_tpu_torch.model import solar_zenith
    if state is None:
        state = model.init_state(B)
    lst = state.tim.lst.clone()
    lst[B // 2:] = 12
    u0 = solar_zenith(lst, state.tim.lmin, model.astro.alat,
                      model.astro.declin, model.dtype)
    state = state.replace(tim=state.tim.replace(lst=lst),
                          rad=state.rad.replace(u0=u0))
    if model._photolysis is not None:
        state = model.photolysis_step(
            state, torch.ones_like(u0, dtype=torch.bool))
    return state


def phase_device_vs_cpu(inpdir):
    """Port on the card (kernels) against the port on the CPU (plain): a
    midnight and a noon column, float64, one minute."""
    from mistra_tpu_torch import Model
    cfg = model_config(inpdir, "float64")
    out = {}
    for dev in (DEVICE, "cpu"):
        model = Model(cfg, device=dev)
        state = model.minute_step(midnight_and_noon(model))
        out[dev] = {k: v.cpu().numpy() for k, v in (
            ("t", state.met.t), ("xm1", state.met.xm1),
            ("ff", state.micro.ff), ("dtrad", state.rad.dtrad),
            ("totrad", state.rad.totrad), ("sk", state.rad.sk),
            ("sl", state.rad.sl))}
    check(out["cpu"]["sk"][1] > 0.0 == out["cpu"]["sk"][0],
          f"noon/midnight sk {out['cpu']['sk']}")
    errs = {}
    for k, tol in DEVICE_TOL.items():
        ref = out["cpu"][k]
        errs[k] = float(np.abs(out[DEVICE][k] - ref).max()
                        / np.abs(ref).max())
        check(errs[k] <= tol, f"{k}: card vs CPU {errs[k]:.3e} > {tol}")
    log("card vs cpu (2 columns at 00:00 and 12:00, float64, 1 minute) max "
        "rel err: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))


def phase_radiation(inpdir):
    """nstrahl on the card against the CPU on the same inputs (a midnight
    and a noon column at the grid's nrlay), float64 and float32; also
    float32 against float64 on the card, the solve's own float32 error."""
    from mistra_tpu_torch import Model
    from mistra_tpu_torch.radiation.driver import nstrahl
    model = Model(model_config(inpdir, "float64"), device=DEVICE)
    state = midnight_and_noon(model)
    drv = model._radiation
    tx, px, rhox, xm1x, ts, bea, baa, ga = drv.load_profile(state)

    def flip(x):
        return torch.flip(x, dims=[-1])

    zeros = torch.zeros_like(bea[:, 0])
    c = drv._consts(tx.device)
    args = [flip(tx), flip(px), flip(rhox), flip(xm1x), ts,
            c["qmo3_td"].expand(2, -1), flip(bea), flip(baa), flip(ga),
            zeros, zeros, zeros, c["thk_td"].expand(2, -1), state.rad.u0,
            c["albedo"], c["emis"], c["berayl"]]
    names = ("hr", "totrad", "fnseb", "flgeg")
    out = {}
    for dtype in (torch.float64, torch.float32):
        for dev in (DEVICE, "cpu"):
            a = [x.to(dev, dtype) for x in args]
            out[dtype, dev] = [r.double().cpu().numpy()
                               for r in nstrahl(drv.pt, *a)]

    def rel(got, ref):
        return {k: float(np.abs(g - r).max() / np.abs(r).max())
                for k, g, r in zip(names, got, ref)}

    for dtype in (torch.float64, torch.float32):
        errs = rel(out[dtype, DEVICE], out[dtype, "cpu"])
        tol = RAD_TOL[dtype]
        log(f"nstrahl card vs cpu ({str(dtype).replace('torch.', '')}, 2 "
            f"columns at 00:00 and 12:00, nrlay {model.cfg.grid.nrlay}) max "
            f"rel err: " + ", ".join(f"{k} {v:.3e} (tol {tol[k]})"
                                     for k, v in errs.items()))
        for k, g in zip(names, out[dtype, DEVICE]):
            check(np.isfinite(g).all(), f"non-finite nstrahl {k}")
            check(errs[k] <= tol[k], f"nstrahl {dtype} {k}: card vs CPU "
                  f"{errs[k]:.3e} > {tol[k]}")
    own = rel(out[torch.float32, DEVICE], out[torch.float64, DEVICE])
    log("nstrahl float32 vs float64 on the card (same inputs): "
        + ", ".join(f"{k} {v:.3e}" for k, v in own.items())
        + f"; fnseb {out[torch.float64, 'cpu'][2]}, flgeg "
        f"{out[torch.float64, 'cpu'][3]} W/m2")


def chem_mechanism(tmp: str):
    """(mechanism, is_reference): $MECHDIR's tot mechanism if it holds the
    reference's master_gas.eqn and master_aqueous.eqn, else the synthetic
    stand-in written to tmp."""
    from mistra_tpu_torch.chemistry.mech import (
        load_multiphase_mechanism, write_synthetic_multiphase_mechanism)
    mechdir = os.environ.get("MECHDIR")
    if mechdir and all(os.path.exists(os.path.join(mechdir, f)) for f in
                       ("master_gas.eqn", "master_aqueous.eqn")):
        log(f"mechanism: reference tot mechanism from MECHDIR ({mechdir})")
        return load_multiphase_mechanism(mechdir, name="tot"), True
    write_synthetic_multiphase_mechanism(tmp)
    log("mechanism: synthetic tot-shaped stand-in (MECHDIR has none)")
    return load_multiphase_mechanism(tmp, name="tot"), False


def chem_inputs(mech, reference, cells, dtype, device, seed=0):
    """(GasKernel, k, fix, y0) for cells with te over 275-295 K, air at
    1 atm and log-normal concentrations, all drawn from seed with numpy
    (the same values on every device)."""
    from mistra_tpu_torch.chemistry.gas_kernel import GasKernel
    from mistra_tpu_torch.chemistry.rates import RateEnv, probe_dry_extras
    rng = np.random.default_rng(seed)
    te = rng.uniform(275.0, 295.0, cells)
    air = 101325.0 / (8.314 * te)                     # mol/m3
    y0 = 1e-8 * rng.lognormal(0.0, 1.0, (cells, mech.nvar))
    # aqueous water of the stand-in's "+ H2Olz" reactions; the reference
    # mechanism runs dry, as benchmarks/bench_chem.py runs it
    cols = {"O2": 0.21 * air, "N2": 0.79 * air, "H2O": np.full(cells, 0.5)}
    aq_water = 0.0 if reference else 1e-2
    fix = np.stack([cols.get(s, np.full(cells, aq_water))
                    for s in mech.fixed], axis=-1)

    def dev(x):
        return torch.tensor(x, dtype=dtype, device=device)

    env = RateEnv(te=dev(te), aircc=dev(air * 6.022e17),
                  h2oppm=dev(np.full(cells, 1.2e4)),
                  pk=dev(np.full(cells, 101325.0)),
                  ph_rat=dev(np.full((cells, 47), 1.0e-5)))
    if reference:
        env = dataclasses.replace(env, extras=probe_dry_extras(
            mech, env, torch.zeros(cells, dtype=dtype, device=device)))
    kern = GasKernel(mech, dtype=dtype, device=device)
    return kern, kern.rate_constants(env, fix=dev(fix)), dev(fix), dev(y0)


def normwise_residual(a, x):
    """max over the batch of ||A X - I|| / (||A|| ||X||), infinity norms."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    r = (a @ x - eye).abs().sum(-1).amax(-1)
    na = a.abs().sum(-1).amax(-1)
    nx = x.abs().sum(-1).amax(-1)
    return (r / (na * nx)).max().item()


def compare_inverse(lu, lu_cuda, a, label):
    """The inverse kernel against the plain version (and torch.linalg.inv
    as a reference figure) on one batch; checks and times them.  Both do
    the same operations in the same order, so bit_equal is expected; a
    differing rounding would still pass within LU_TOL."""
    n, m, _ = a.shape
    dtype = a.dtype
    # reads A, writes X; Gauss-Jordan does ~m^3 multiply-adds per matrix
    bnd = bound(2 * a.numel() * a.element_size(), 2.0 * n * m ** 3, dtype)
    xk = lu_cuda.batched_inv(a)
    xp = lu.batched_inv_plain(a)
    xl = torch.linalg.inv(a)
    torch.cuda.synchronize()
    rel = ((xk - xp).abs().amax() / xp.abs().amax()).item()
    bit_equal = bool(torch.equal(xk, xp))
    res_k, res_l = normwise_residual(a, xk), normwise_residual(a, xl)
    res_tol = LU_RES_FACTOR * m * torch.finfo(dtype).eps
    out = dict(
        max_abs_err=(xk - xp).abs().max().item(), rel_err=rel,
        bit_equal=bit_equal, tol=LU_TOL[dtype], residual=res_k,
        linalg_residual=res_l, residual_tol=res_tol,
        shape=f"{n}x{m}x{m} {str(dtype).replace('torch.', '')} {label}",
        ms=cuda_ms(lambda: lu_cuda.batched_inv(a), 10),
        plain_ms=cuda_ms(lambda: lu.batched_inv_plain(a), 2, warmup=1),
        library_ms=cuda_ms(lambda: torch.linalg.inv(a), 5), **bnd)
    out["roofline_share"] = out["bound_ms"] / out["ms"]
    log(f"batched_inv {out['shape']}: err {out['max_abs_err']:.3e} (rel "
        f"{rel:.3e}, bit-equal {bit_equal}), residual {res_k:.3e} "
        f"(linalg.inv {res_l:.3e}); "
        f"{out['ms']:.3f} ms vs plain {out['plain_ms']:.3f} ms, "
        f"linalg.inv {out['library_ms']:.3f} ms, bound "
        f"{out['bound_ms']:.3f} ms ({out['bound_by']}, "
        f"{100.0 * out['roofline_share']:.1f} %)")
    check(bool(torch.isfinite(xk).all()), f"non-finite inverse {label}")
    check(rel <= LU_TOL[dtype], f"inverse disagrees: {rel} > {LU_TOL[dtype]}")
    check(res_k <= res_tol, f"inverse residual {res_k} > {res_tol}")
    return out


def phase_lu(mech, reference):
    """Kernel against plain at the chemistry solve's shapes, both dtypes,
    three kinds of input; returns the results per (dtype, m, kind)."""
    from mistra_tpu_torch.chemistry import lu, lu_cuda
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {torch.cuda.get_device_properties(0).multi_processor_count} "
        f"SMs, max SM clock {clock} MHz (one block per matrix)")
    out = {}
    for dtype in (torch.float64, torch.float32):
        kern, k, fix, y = chem_inputs(mech, reference, CHEM_CELLS, dtype,
                                      DEVICE)
        rng = np.random.default_rng(5)
        ghinv = torch.tensor(10.0 ** rng.uniform(-0.5, 5.0, CHEM_CELLS),
                             dtype=dtype, device=DEVICE)
        blk = kern.block
        # the equilibrated stage matrices R (ghinv I - J) whose inverses
        # the solve takes: the aqueous blocks and the Schur complement
        fact = blk.prepare(blk.assemble(kern.kw_weights(y, k, fix)), ghinv)
        stage = (fact.abb.reshape(-1, blk.ma, blk.ma), fact.s)
        del fact, kern
        for a_stage in stage:
            out.update(inverse_cases(lu, lu_cuda, a_stage, rng,
                                     ("stage", "dominant", "pivoting")))
    return out


def inverse_cases(lu, lu_cuda, a_stage, rng, kinds, path=""):
    """The kernel's launch plan for a_stage's m (checked against the
    Python plan) and compare_inverse on each of kinds: the stage matrices
    a_stage [N, m, m], a diagonally dominant batch and a batch that needs
    pivoting, of the same shape and dtype; results per (dtype, m, kind)."""
    n, m, _ = a_stage.shape
    dtype = a_stage.dtype
    plan = lu_cuda.launch_plan(m, dtype)
    got = lu_cuda.kernel_plan(m, dtype)
    check(got["plan"] == plan, f"C plan {got['plan']} != {plan}")
    log(f"batched_inv plan m={m} {str(dtype).replace('torch.', '')}{path}: "
        f"{plan.variant}, tile {plan.ry}x{plan.rx} per thread on "
        f"{plan.ty} lanes x {plan.tx} warps, {plan.threads} threads, "
        f"{plan.smem_bytes} B shared memory; {got['blocks_per_sm']} "
        f"blocks per SM")
    out = {}
    for kind in kinds:
        if kind == "stage":
            a = a_stage
        elif kind == "dominant":
            a = rng.random((n, m, m)) + 4.0 * np.eye(m)
        else:
            a = rng.standard_normal((n, m, m))
            a[:, np.arange(m // 2), np.arange(m // 2)] = 0.0
        a = torch.as_tensor(a, dtype=dtype, device=DEVICE)
        r = compare_inverse(lu, lu_cuda, a, kind + path)
        r["plan"] = dataclasses.asdict(plan)
        r["blocks_per_sm"] = got["blocks_per_sm"]
        out[(dtype, m, kind)] = r
    return out


def phase_chem(mech, reference):
    """The stiff chemistry solve on the card: GasKernel.integrate for
    CHEM_CELLS cells in float64, one warm substep then CHEM_TIMED timed
    ones, each from the last (clamped at 0, as benchmarks/bench_chem.py);
    then one more under torch.profiler; returns the inverse kernel's
    launches, the Ros3 loop iterations and the path's figures."""
    from mistra_tpu_torch.chemistry import lu_cuda, rosenbrock
    kern, k, fix, y = chem_inputs(mech, reference, CHEM_CELLS,
                                  torch.float64, DEVICE)
    check(kern.block.nbin > 0, f"aqueous bins {kern.block.nbin}")
    torch.cuda.synchronize()
    lu_cuda.reset_counts()
    rosenbrock.reset_counts()
    iterations, times, steps = 0, [], []
    for _ in range(1 + CHEM_TIMED):
        t0 = time.perf_counter()
        y, info = kern.integrate(y, k, fix, CHEM_DT)
        y = torch.clamp(y, min=0.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        nsteps = info["nsteps"].cpu().numpy()
        steps.append(nsteps)
        iterations += int(nsteps.max())
        check(int(info["n_failed"]) == 0, f"{int(info['n_failed'])} cells "
              "failed")
        check(bool(info["done"].all()), "cells not done")
        check(bool(torch.isfinite(y).all()), "non-finite concentrations")
    (y, info), wall, busy, events, top = profile_call(
        lambda: kern.integrate(y, k, fix, CHEM_DT))
    iterations += int(info["nsteps"].max())
    check(int(info["n_failed"]) == 0, "cells failed (profiled substep)")
    launches = lu_cuda.batched_inv.launches
    check(tuple(y.shape) == (CHEM_CELLS, mech.nvar), f"y shape {y.shape}")
    # two inverses per Ros3 step attempt, and nothing else calls the kernel
    check(launches == 2 * iterations,
          f"batched_inv launches {launches} != 2 x {iterations} iterations")
    check_graph_iterations("chemistry path", ros3_counts(), iterations,
                           captures=1)
    timed = times[1:]
    rate = CHEM_CELLS * len(timed) / sum(timed)
    log(f"chemistry path: {CHEM_CELLS} cells, float64, nvar {mech.nvar}, "
        f"nrxn {mech.nrxn}; substeps {[round(t, 3) for t in times]} s "
        f"(first warm); {rate:.1f} cell-substeps/s over {len(timed)} timed "
        f"substeps; Ros3 steps per cell mean/max: warm "
        f"{steps[0].mean():.1f}/{steps[0].max()}, timed "
        f"{np.mean(steps[1:]):.1f}/{np.max(steps[1:])}; n_failed 0; "
        f"batched_inv launches {launches} = 2 x {iterations} iterations")
    log_profile(f"one chemistry substep ({int(info['nsteps'].max())} Ros3 "
                f"iterations)", wall, busy, events, top)
    inv_ms = sum(t for n, _, t in top if "gj_inverse" in n)
    log(f"chemistry substep: gj_inverse kernels {inv_ms:.3f} ms, "
        f"{100.0 * inv_ms / (1e3 * busy):.1f} % of device busy")
    return launches, iterations, {
        "cell_substeps_per_s": rate,
        "ros3_steps_mean": float(np.mean(steps[1:])),
        "ros3_steps_max": int(np.max(steps[1:])),
        "profiled_substep_wall_ms": 1e3 * wall,
        "profiled_substep_busy_ms": 1e3 * busy,
        "profiled_substep_top_kernels": [
            {"kernel": n, "launches": c, "ms": t} for n, c, t in top]}


def phase_chem_device_vs_cpu(mech, reference):
    """Chemistry path on the card (kernel) against the CPU (plain
    inverse): CHEM_CMP_CELLS cells, float64, one substep."""
    out = {}
    for dev in (DEVICE, "cpu"):
        kern, k, fix, y0 = chem_inputs(mech, reference, CHEM_CMP_CELLS,
                                       torch.float64, dev, seed=1)
        y, info = kern.integrate(y0, k, fix, CHEM_DT)
        check(int(info["n_failed"]) == 0, f"{dev}: cells failed")
        out[dev] = (y.cpu().numpy(), info["nsteps"].cpu().numpy())
    ref = out["cpu"][0]
    scale = np.maximum(np.abs(ref).max(axis=0), 1e-300)
    err = float((np.abs(out[DEVICE][0] - ref) / scale).max())
    ndiff = int((out[DEVICE][1] != out["cpu"][1]).sum())
    log(f"chemistry card vs cpu ({CHEM_CMP_CELLS} cells, float64, one "
        f"substep): max err {err:.3e} of each species' largest |y| (tol "
        f"{CHEM_DEVICE_TOL}); nsteps differ in {ndiff} of "
        f"{CHEM_CMP_CELLS} cells (cpu mean {out['cpu'][1].mean():.1f})")
    check(err <= CHEM_DEVICE_TOL, f"chemistry card vs CPU {err:.3e}")


def chem_t_config(inpdir, mechdir, dtype):
    from mistra_tpu_torch import GridParams, MistraConfig
    return MistraConfig(grid=GRID or GridParams(), dtype=dtype,
                        inpdir=inpdir, mechdir=mechdir, **CHEM_T)


def phase_lu_chem_t(mechdir):
    """The inverse kernel at the chem=T minute's shapes: the gas
    mechanism's stage matrices for one cell per interior layer of
    CHEM_T_COLUMNS columns (2 bins of m = 4, the gas core of m = 95), in
    float32 (phase 8) and float64 (phase 9), and a batch of each shape
    that needs pivoting; returns the results per (dtype, m, kind)."""
    from mistra_tpu_torch import GridParams
    from mistra_tpu_torch.chemistry import lu, lu_cuda
    from mistra_tpu_torch.chemistry.mech import load_gas_mechanism
    mech = load_gas_mechanism(mechdir)
    cells = CHEM_T_COLUMNS * ((GRID or GridParams()).n - 2)
    out = {}
    for dtype in (torch.float32, torch.float64):
        kern, k, fix, y = chem_inputs(mech, False, cells, dtype, DEVICE)
        check(kern.block.nbin > 0,
              f"gas mechanism aqueous bins {kern.block.nbin}")
        rng = np.random.default_rng(6)
        ghinv = torch.tensor(10.0 ** rng.uniform(-0.5, 5.0, cells),
                             dtype=dtype, device=DEVICE)
        blk = kern.block
        fact = blk.prepare(blk.assemble(kern.kw_weights(y, k, fix)), ghinv)
        stage = (fact.abb.reshape(-1, blk.ma, blk.ma), fact.s)
        del fact, kern
        for a_stage in stage:
            out.update(inverse_cases(lu, lu_cuda, a_stage, rng,
                                     ("stage", "pivoting"), " chem=T"))
    for (dtype, m, kind), r in out.items():
        check(r["bit_equal"], f"inverse m={m} {dtype} {kind} is not "
              "bit-equal to the plain version")
    return out


@contextlib.contextmanager
def ros3_solves(*kernels):
    """While open, the lists it yields, one per kernel, gain the Ros3 info
    of every integrate call of that kernel."""
    seen = [[] for _ in kernels]
    saved = [k.integrate for k in kernels]

    def recording(f, calls):
        def integrate(*a, **kw):
            y, info = f(*a, **kw)
            calls.append(info)
            return y, info
        return integrate

    for k, f, calls in zip(kernels, saved, seen):
        k.integrate = recording(f, calls)
    try:
        yield seen
    finally:
        for k, f in zip(kernels, saved):
            k.integrate = f


@contextlib.contextmanager
def sed_calls():
    """While open, the dict it yields counts sedp's calls (``sedp``), its
    host checks (``sync.sedp``: one per Courant pass and one that ends the
    loop) and sedl's calls that reach the splits (``sync.sedl``), whether
    the tracer is on or not; the sedimentation kernel's counters are set
    to 0 on entry (``sed_counts`` reads them)."""
    from mistra_tpu_torch.chemistry import driver_aq
    from mistra_tpu_torch.physics import sed_cuda
    from mistra_tpu_torch.physics import sedimentation as sed
    seen = {"sedp": 0, "sync.sedp": 0, "sync.sedl": 0}
    saved = sed.sedp, sed.count, driver_aq.count

    def counting(f):
        def count(name, n=1):
            if name in seen:
                seen[name] += n
            f(name, n)
        return count

    def sedp(*a, **kw):
        seen["sedp"] += 1
        return saved[0](*a, **kw)

    sed.sedp, sed.count = sedp, counting(saved[1])
    driver_aq.count = counting(saved[2])
    sed_cuda.reset_counts()
    try:
        yield seen
    finally:
        sed.sedp, sed.count, driver_aq.count = saved


def sed_counts(seen, what):
    """The sedimentation kernel's launches since ``sed_calls`` opened seen:
    advsed (``sed_advect``) once per sedp pass, advsed_splits
    (``sed_splits``) once per sedl call, checked."""
    from mistra_tpu_torch.physics import sed_cuda
    counts = {"sed_advect": sed_cuda.advsed.launches,
              "sed_splits": sed_cuda.advsed_splits.launches}
    passes = seen["sync.sedp"] - seen["sedp"]
    check(counts["sed_advect"] == passes,
          f"{what}: sed_advect launches {counts['sed_advect']} != {passes} "
          f"sedp passes in {seen['sedp']} calls")
    check(counts["sed_splits"] == seen["sync.sedl"],
          f"{what}: sed_splits launches {counts['sed_splits']} != "
          f"{seen['sync.sedl']} sedl calls")
    return counts


def ros3_summary(infos):
    """One kernel's integrate calls: Ros3 steps and failures per cell
    [calls, cells], and the loop iterations (each call's largest step
    count: the batched inverse launches twice per iteration)."""
    if not infos:
        return {"nsteps": np.zeros((0, 0), np.int64),
                "failed": np.zeros((0, 0), bool), "iterations": 0}
    nsteps = torch.stack([i["nsteps"] for i in infos]).cpu().numpy()
    return {"nsteps": nsteps,
            "failed": torch.stack([i["failed"] for i in infos]).cpu().numpy(),
            "iterations": int(nsteps.max(axis=1).sum())}


def run_minutes(step, state, minutes, kernels, bott_cuda, lu_cuda,
                after_minute=None):
    """minutes of step(state) with every kernel's launch counter set to 0
    just before and read just after (the sedimentation kernel's checked
    against sedp's passes and sedl's calls), and the Ros3 solves of kernels
    recorded; after_minute(minute, state) runs after each minute, outside
    the timing.  Returns (state, minute times in s, launch counts, one
    ``ros3_summary`` per kernel)."""
    from mistra_tpu_torch.chemistry import rosenbrock
    times = []
    with ros3_solves(*kernels) as solves, sed_calls() as seen:
        bott_cuda.reset_counts()
        lu_cuda.reset_counts()
        rosenbrock.reset_counts()
        for minute in range(minutes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = step(state)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if after_minute is not None:
                after_minute(minute, state)
        counts = {"bott_dwsum": bott_cuda.bott_dwsum.launches,
                  "bott_advect": bott_cuda.bott_advect.launches,
                  "batched_inv": lu_cuda.batched_inv.launches,
                  **sed_counts(seen, "minute run"), **ros3_counts()}
    return state, times, counts, [ros3_summary(c) for c in solves]


def ros3_counts():
    """The Ros3 loop's counters since their reset: its iterations, those
    replayed from CUDA graphs and the graph sets captured."""
    from mistra_tpu_torch.chemistry import rosenbrock
    return {"ros3_iters": rosenbrock.COUNTS["ros3.iters"],
            "ros3_graph_iters": rosenbrock.COUNTS["ros3.graph_iters"],
            "ros3_graph_captures": rosenbrock.COUNTS["ros3.graph_captures"]}


def check_graph_iterations(what, counts, iterations, captures=None):
    """Every Ros3 iteration counted, and each replayed from CUDA graphs
    but the one that runs op by op before each capture (captures, if
    given, the sets expected)."""
    got = counts["ros3_graph_captures"]
    check(counts["ros3_iters"] == iterations
          and counts["ros3_graph_iters"] == iterations - got
          and (captures is None or got == captures),
          f"{what}: {iterations} Ros3 iterations; counted "
          f"{counts['ros3_iters']}, {counts['ros3_graph_iters']} replayed "
          f"from graphs after {got} captures")


def loop_iterations(solves):
    return sum(r["iterations"] for r in solves)


def minute_figures(B, times, counts, iterations, nonconv):
    """The figures of a path's run: minute times in ms, the steady minute
    (the first, the init transient, left out) and the mean of all
    minutes with their column-minutes/s, launches, Ros3 iterations and
    nonconv."""
    steady = times[1:] if len(times) > 1 else times
    ms = 1e3 * sum(steady) / len(steady)
    mean_ms = 1e3 * sum(times) / len(times)
    return {"columns": B, "minutes": len(times),
            "minute_ms": [1e3 * t for t in times], "steady_minute_ms": ms,
            "column_minutes_per_s": B / (ms / 1e3), "mean_minute_ms": mean_ms,
            "mean_column_minutes_per_s": B / (mean_ms / 1e3),
            "launches": counts, "ros3_iterations": iterations,
            "nonconv": nonconv}


def profile_minute(what, step, state, fig):
    """One more minute of step(state) under torch.profiler, its wall and
    device time and top kernels logged and added to fig."""
    _, wall, busy, events, top = profile_call(lambda: step(state))
    log_profile(f"one {what} minute", wall, busy, events, top)
    fig.update(profiled_minute_wall_ms=1e3 * wall,
               profiled_minute_busy_ms=1e3 * busy,
               profiled_minute_events=events,
               profiled_minute_top_kernels=[
                   {"kernel": n, "launches": c, "ms": t} for n, c, t in top])


def check_launches(what, counts, iterations, bott, minutes=MODE_MINUTES,
                   sedl=False):
    """The inverse launched twice per Ros3 iteration, every iteration
    after a capture replayed from CUDA graphs; both Bott kernels
    launched (dwsum at least once, advect once per substep) and the
    sedimentation kernel at least once per substep (sedp's passes) in
    minutes minutes of a path with the particle physics (bott), none of
    them on one without; the sedimentation kernel's splits once per
    substep on a path with the multiphase driver's sedl, never on one
    without (``run_minutes`` held the sedimentation launches to sedp's
    passes and sedl's calls)."""
    check(counts["batched_inv"] == 2 * iterations,
          f"{what}: batched_inv launches {counts['batched_inv']} != 2 x "
          f"{iterations} Ros3 iterations")
    check_graph_iterations(what, counts, iterations)
    if bott:
        check(counts["bott_dwsum"] >= 6 * minutes
              and counts["bott_advect"] == 6 * minutes
              and counts["sed_advect"] >= 6 * minutes,
              f"{what}: Bott and sedp launches {counts}")
    else:
        check(counts["bott_dwsum"] == counts["bott_advect"]
              == counts["sed_advect"] == 0,
              f"{what}: Bott and sedp launches {counts} without the "
              f"particle physics")
    check(counts["sed_splits"] == (6 * minutes if sedl else 0),
          f"{what}: sedl launches {counts['sed_splits']}")


def check_state(state, what):
    """Every floating field of state finite, the chemistry's where the
    state has one."""
    for sub in ("met", "turb", "surf", "micro", "rad", "chem"):
        if getattr(state, sub) is None:
            continue
        for name, x in vars(getattr(state, sub)).items():
            if x.is_floating_point():
                check(bool(torch.isfinite(x).all()),
                      f"{what}: non-finite {sub}.{name}")


def phase_chem_t(inpdir, mechdir, bott_cuda, lu_cuda):
    """The chem=T minute on the card: CHEM_T_COLUMNS columns, half at
    00:00 and half at 12:00, float32, CHEM_T_MINUTES minutes with every
    kernel's launch counter set to 0 just before and read just after;
    then the photolysis call alone and one more minute under
    torch.profiler.  Returns the launch counts, the Ros3 loop iterations
    and the path's figures."""
    from mistra_tpu_torch import Model
    cfg = chem_t_config(inpdir, mechdir, "float32")
    model = Model(cfg, device=DEVICE)
    B = CHEM_T_COLUMNS
    t0 = time.perf_counter()
    state = midnight_and_noon(model, B)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    drv = model._chemistry
    check(type(drv).__name__ == "ChemistryDriver", f"driver {type(drv)}")
    check(drv.kernel.block.nbin > 0,
          f"aqueous bins {drv.kernel.block.nbin}")
    check(model._photolysis is not None, "no photolysis driver")
    noon = torch.arange(B, device=state.rad.u0.device) >= B // 2

    t_start = state.tim.time.clone()
    pj_start = state.chem.photol_j.clone()
    held = []

    def odd_minute(minute, st):
        if minute == 0:
            held.append(bool(torch.equal(st.chem.photol_j, pj_start)))

    state, times, counts, (gas,) = run_minutes(
        model.minute_step, state, CHEM_T_MINUTES, (drv.kernel,), bott_cuda,
        lu_cuda, after_minute=odd_minute)
    nsteps, iters = gas["nsteps"], gas["iterations"]    # [substeps, cells]

    gp = cfg.grid
    check_state(state, "chem=T minute")
    check(tuple(state.chem.sgas.shape) == (B, drv.mech.nvar, gp.n),
          f"sgas shape {tuple(state.chem.sgas.shape)}")
    advanced = (state.tim.time - t_start).cpu().numpy()
    check(np.all(advanced == 60.0 * CHEM_T_MINUTES), f"clock {advanced}")
    check(bool((state.tim.lmin == CHEM_T_MINUTES).all()), "minute counter")
    pj = state.chem.photol_j
    check(bool((pj[noon].amax(dim=(1, 2)) > 0.0).all()),
          "J-rates all zero in a noon column")
    check(bool((pj[~noon] == 0.0).all()), "J-rates in a midnight column")
    check(held == [True], "the J-rates changed on the odd minute")
    check_launches("chem=T minute", counts, iters, bott=True,
                   minutes=CHEM_T_MINUTES)
    nonconv = state.chem.nonconv.cpu().numpy()
    fig = minute_figures(B, times, counts, iters, int(nonconv.sum()))
    ms, mean_ms = fig["steady_minute_ms"], fig["mean_minute_ms"]
    log(f"chem=T minute: {B} columns (half at 00:00, half at 12:00) x "
        f"{CHEM_T_MINUTES} minutes, float32, grid n={gp.n} nka={gp.nka} "
        f"nkt={gp.nkt}, nvar {drv.mech.nvar}, nrxn {drv.mech.nrxn}, "
        f"{nsteps.shape[1]} cells; init {init_s:.2f} s; minute step "
        f"{[round(1e3 * t, 1) for t in times]} ms, steady {ms:.1f} ms = "
        f"{B / (ms / 1e3):.2f} column-minutes/s (mean of all minutes "
        f"{mean_ms:.1f} ms = {B / (mean_ms / 1e3):.2f}); Ros3 steps per "
        f"cell and substep mean {nsteps.mean():.2f} max {nsteps.max()} (first "
        f"substep {nsteps[0].mean():.2f}/{nsteps[0].max()}), {iters} "
        f"loop iterations; nonconv {int(nonconv.sum())} (max per column "
        f"{int(nonconv.max())}); launches {counts}; J_NO2 at the surface "
        f"of a noon column {pj[B - 1, 0, 1].item():.3e} 1/s")

    # the photolysis call alone, as post_minute makes it on even minutes
    phot_s = []
    for _ in range(PHOT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model._photolysis(state)
        torch.cuda.synchronize()
        phot_s.append(time.perf_counter() - t0)
    dev_events, ops = count_launches(lambda: model._photolysis(state))
    phot_ms = 1e3 * sum(phot_s) / len(phot_s)
    log(f"photolysis call: {B} columns, 176 intervals x nrlay {gp.nrlay} "
        f"layers; {[round(1e3 * t, 2) for t in phot_s]} ms, mean "
        f"{phot_ms:.2f} ms; per call {dev_events} device events, {ops} "
        f"aten ops")

    fig.update(init_s=init_s, ros3_steps_mean=float(nsteps.mean()),
               ros3_steps_max=int(nsteps.max()), photolysis_ms=phot_ms,
               photolysis_device_events=dev_events, photolysis_aten_ops=ops)
    profile_minute("chem=T", model.minute_step, state, fig)
    return counts, iters, fig


def rows_err(got, ref):
    """max over rows (axis 1: species, J slots) of max |got - ref| over
    columns and levels, relative to the row's largest |ref| (a row that
    is zero in ref counts its absolute difference)."""
    scale = np.abs(ref).max(axis=(0, 2))
    diff = np.abs(got - ref).max(axis=(0, 2))
    return float(np.where(scale > 0.0, diff / np.where(scale > 0.0, scale,
                                                        1.0), diff).max())


def phase_chem_t_device_vs_cpu(inpdir, mechdir):
    """The chem=T port on the card (kernels) against the port on the CPU
    (plain versions): a midnight and a noon column, float64, two minutes,
    CHEM_T_CMP_GRID's depth; then photolysis alone on the same inputs,
    float64 and float32."""
    from mistra_tpu_torch import GridParams, Model

    def config(dtype):
        cfg = chem_t_config(inpdir, mechdir, dtype)
        if GRID is None:
            cfg.grid = GridParams(**CHEM_T_CMP_GRID)
            cfg.zinv = CHEM_T_CMP_ZINV
        return cfg
    cfg = config("float64")
    out, models, wall = {}, {}, {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        model = Model(cfg, device=dev)
        state = midnight_and_noon(model)
        for _ in range(CHEM_T_MINUTES):
            state = model.minute_step(state)
        check_state(state, f"chem=T on {dev}")
        models[dev] = model
        wall[dev] = time.perf_counter() - t0
        out[dev] = {k: v.cpu().numpy() for k, v in (
            ("t", state.met.t), ("xm1", state.met.xm1),
            ("ff", state.micro.ff), ("sgas", state.chem.sgas),
            ("photol_j", state.chem.photol_j),
            ("nonconv", state.chem.nonconv))}
        if dev == "cpu":
            last = state
    ref, got = out["cpu"], out[DEVICE]
    check(float(ref["photol_j"][1].max()) > 0.0 == float(
        ref["photol_j"][0].max()), "noon/midnight J-rates")
    errs = {}
    for k, tol in CHEM_T_DEVICE_TOL.items():
        if k in ("sgas", "photol_j"):
            errs[k] = rows_err(got[k], ref[k])
        else:
            errs[k] = float(np.abs(got[k] - ref[k]).max()
                            / np.abs(ref[k]).max())
        check(errs[k] <= tol, f"chem=T {k}: card vs CPU {errs[k]:.3e} > "
              f"{tol}")
    log(f"chem=T card vs cpu (2 columns at 00:00 and 12:00, float64, "
        f"nf={cfg.grid.nf} n={cfg.grid.n} nka={cfg.grid.nka} "
        f"nkt={cfg.grid.nkt}, {CHEM_T_MINUTES} minutes; card "
        f"{wall[DEVICE]:.1f} s, cpu {wall['cpu']:.1f} s) max rel err: "
        + ", ".join(f"{k} {v:.3e} (tol {CHEM_T_DEVICE_TOL[k]})"
                    for k, v in errs.items())
        + f"; nonconv card {got['nonconv'].tolist()} cpu "
        f"{ref['nonconv'].tolist()}")

    # photolysis alone: the CPU run's last state, on each device, in the
    # model's dtype
    for dtype, name in ((torch.float64, "float64"),
                        (torch.float32, "float32")):
        res = {}
        for dev in (DEVICE, "cpu"):
            model = models[dev]
            if dtype != torch.float64:
                model = Model(config(name), device=dev)
                model.init_state(1)
            st = last.map(lambda x: x.to(dev, dtype)
                          if x.is_floating_point() else x.to(dev))
            res[dev] = model._photolysis(st).double().cpu().numpy()
        err = rows_err(res[DEVICE], res["cpu"])
        log(f"photolysis card vs cpu ({name}, 2 columns at 00:00 and 12:00,"
            f" the same inputs): max err {err:.3e} of each slot's largest "
            f"value (tol {PHOT_TOL[dtype]})")
        check(np.isfinite(res[DEVICE]).all(), f"non-finite J-rates {name}")
        check(err <= PHOT_TOL[dtype], f"photolysis {name}: card vs CPU "
              f"{err:.3e}")


def tot_mechanism_dir(tmp: str):
    """(directory, is_reference) of the multiphase minute's mechanism:
    $MECHDIR when it holds the reference's gas and tot mechanism files,
    else tmp with the synthetic tot stand-in of the reference's shape
    written to it."""
    from mistra_tpu_torch.chemistry.mech import write_synthetic_tot_mechanism
    mechdir = os.environ.get("MECHDIR")
    if mechdir and all(os.path.exists(os.path.join(mechdir, f))
                       for f in TOT_FILES):
        log(f"tot mechanism: reference tot mechanism from MECHDIR "
            f"({mechdir})")
        return mechdir, True
    write_synthetic_tot_mechanism(tmp)
    log("tot mechanism: synthetic stand-in of the reference's shape "
        f"(MECHDIR lacks {', '.join(TOT_FILES)})")
    return tmp, False


def multiphase_config(inpdir, mechdir, dtype, grid=None, **kw):
    from mistra_tpu_torch import GridParams, MistraConfig
    return MistraConfig(grid=grid or GRID or GridParams(), dtype=dtype,
                        inpdir=inpdir, mechdir=mechdir,
                        **dict(MULTIPHASE, **kw))


def capture_inverse_inputs(solve):
    """{(dtype, m): the input of the first batched inverse of each shape}
    in solve(), one chemistry substep: for the multiphase driver's
    integrate_column the tot solve's aqueous blocks and gas core, the
    gas-above solve's bins and gas core."""
    from mistra_tpu_torch.chemistry import block_solver
    seen = {}
    inverse = block_solver.batched_inv

    def keep(a, out=None):
        seen.setdefault((a.dtype, a.shape[-1]), a.clone())
        return inverse(a, out=out)

    block_solver.batched_inv = keep
    try:
        solve()
    finally:
        block_solver.batched_inv = inverse
    torch.cuda.synchronize()
    return seen


def phase_multiphase(inpdir, mechdir, growth, bott_cuda, lu_cuda):
    """The multiphase minute on the card: MP_COLUMNS columns, half at
    00:00 and half at 12:00, float32 (the tot solve in float64),
    MP_MINUTES minutes with every kernel's launch counter set to 0 just
    before and read just after; then liq_parm alone, the inverse's inputs
    on this path, and one more minute under torch.profiler, keeping the
    inputs of its first Bott launches.  Returns the launch counts, the
    Ros3 loop iterations of both solves, the path's figures, the
    inverse's inputs and the Bott kernels' inputs."""
    from mistra_tpu_torch import Model
    cfg = multiphase_config(inpdir, mechdir, "float32")
    model = Model(cfg, device=DEVICE)
    B = MP_COLUMNS
    t0 = time.perf_counter()
    state = midnight_and_noon(model, B)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    drv = model._chemistry
    check(type(drv).__name__ == "MultiphaseDriver", f"driver {type(drv)}")
    check(drv.tot_kernel.block.nbin > 0
          and drv.tot_kernel.dtype == torch.float64,
          f"tot aqueous bins {drv.tot_kernel.block.nbin} "
          f"{drv.tot_kernel.dtype}")
    check(model._photolysis is not None, "no photolysis driver")
    noon = torch.arange(B, device=state.rad.u0.device) >= B // 2

    t_start = state.tim.time.clone()
    state, times, counts, (tot, gas) = run_minutes(
        model.minute_step, state, MP_MINUTES, (drv.tot_kernel, drv.kernel),
        bott_cuda, lu_cuda)
    it_tot, it_gas = tot["iterations"], gas["iterations"]
    # (substep, layer) of every cell that ran out of Ros3 steps
    sub, cell = np.nonzero(tot["failed"])
    where_failed = sorted({(int(a), int(c) % (cfg.grid.nf - 1) + 1)
                           for a, c in zip(sub, cell)})
    tot, gas = tot["nsteps"], gas["nsteps"]             # [substeps, cells]

    gp = cfg.grid
    check_state(state, "multiphase minute")
    check(tuple(state.chem.conc.shape) == (B, drv.tot.nvar, gp.n),
          f"conc shape {tuple(state.chem.conc.shape)}")
    advanced = (state.tim.time - t_start).cpu().numpy()
    check(np.all(advanced == 60.0 * MP_MINUTES), f"clock {advanced}")
    check(bool((state.tim.lmin == MP_MINUTES).all()), "minute counter")
    pj = state.chem.photol_j
    check(bool((pj[noon].amax(dim=(1, 2)) > 0.0).all()),
          "J-rates all zero in a noon column")
    check(bool((pj[~noon] == 0.0).all()), "J-rates in a midnight column")
    check_launches("multiphase minute", counts, it_tot + it_gas, bott=True,
                   minutes=MP_MINUTES, sedl=True)
    nonconv = state.chem.nonconv.cpu().numpy()
    fig = minute_figures(B, times, counts, it_tot + it_gas,
                         int(nonconv.sum()))
    ms, mean_ms = fig["steady_minute_ms"], fig["mean_minute_ms"]
    aq = torch.as_tensor(np.nonzero(np.asarray(drv.tot.species_bin))[0],
                         device=state.chem.conc.device)
    aq_max = state.chem.conc[:, aq, 1:gp.nf].amax().item()
    blk = drv.tot_kernel.block
    log(f"multiphase minute: {B} columns (half at 00:00, half at 12:00) x "
        f"{MP_MINUTES} minutes, float32 state, tot solve float64, grid "
        f"n={gp.n} nf={gp.nf} nka={gp.nka} nkt={gp.nkt}; tot nvar "
        f"{drv.tot.nvar}, nrxn {drv.tot.nrxn}, {blk.nbin} bins of ma "
        f"{blk.ma}, mg {blk.mg}, {tot.shape[1]} cells; gas above nvar "
        f"{drv.mech.nvar}, {gas.shape[1]} cells; init {init_s:.2f} s; "
        f"minute step {[round(1e3 * t, 1) for t in times]} ms, steady "
        f"{ms:.1f} ms = {B / (ms / 1e3):.2f} column-minutes/s (mean of all "
        f"minutes {mean_ms:.1f} ms = {B / (mean_ms / 1e3):.2f})")
    log(f"multiphase Ros3: tot {it_tot} loop iterations, steps per cell and "
        f"substep mean {tot.mean():.2f} max {tot.max()} (first substep "
        f"{tot[0].mean():.2f}/{tot[0].max()}); gas above {it_gas} loop "
        f"iterations, steps per cell and substep mean {gas.mean():.2f} max "
        f"{gas.max()}; nonconv {int(nonconv.sum())} (max per column "
        f"{int(nonconv.max())}; (substep, layer) of the failed cells "
        f"{where_failed}); launches {counts}; largest aqueous "
        f"concentration below nf {aq_max:.3e} mol/m3")

    liq_s = []
    for _ in range(LIQ_PARM_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv.liq_parm(state)
        torch.cuda.synchronize()
        liq_s.append(time.perf_counter() - t0)
    liq_ms = 1e3 * sum(liq_s) / len(liq_s)
    log(f"liq_parm: {B} columns, {len(drv.exch)} exchange species; "
        f"{[round(1e3 * t, 2) for t in liq_s]} ms, mean {liq_ms:.2f} ms "
        f"(6 calls per minute: {100.0 * 6 * liq_ms / ms:.1f} % of the "
        f"steady minute)")
    inputs = capture_inverse_inputs(
        lambda: drv.integrate_column(state, DT))

    fig.update(init_s=init_s, tot_nvar=drv.tot.nvar, tot_nrxn=drv.tot.nrxn,
               tot_cells=int(tot.shape[1]), gas_cells=int(gas.shape[1]),
               tot_ros3_iterations=it_tot,
               tot_ros3_steps_mean=float(tot.mean()),
               tot_ros3_steps_max=int(tot.max()),
               gas_ros3_iterations=it_gas,
               gas_ros3_steps_mean=float(gas.mean()),
               gas_ros3_steps_max=int(gas.max()),
               failed_substep_layer=where_failed, liq_parm_ms=liq_ms)
    with keeping_bott_inputs(growth) as bott_inputs:
        profile_minute("multiphase", model.minute_step, state, fig)
    return counts, it_tot + it_gas, fig, inputs, bott_inputs


def phase_bott_multiphase(growth, bott_cuda, kept):
    """Both Bott kernels against their plain versions at the multiphase
    minute's own rows: the inputs of its first dwsum and advect launches
    (float32, every column's layers below nf x nka rows of nkt bins)."""
    dt, u, z, e, J = kept["dwsum"]
    dt_a, u_a, z_a, J_a = kept["advect"]
    check(dt_a == dt and J_a == J, f"advect's dt, band {dt_a}, {J_a} "
          f"differ from dwsum's {dt}, {J}")
    return compare_bott(growth, bott_cuda, dt, (u, z), (u_a, z_a), e, J,
                        plain_reps=3, what=" (multiphase rows)")


def phase_lu_multiphase(inputs, path="multiphase"):
    """The inverse kernel at a path's own shapes and dtypes (by default
    the multiphase minute's): the path's stage matrices and a batch of
    each shape that needs pivoting, bit-equal to the plain version;
    returns the results per (dtype, m, kind)."""
    from mistra_tpu_torch.chemistry import lu, lu_cuda
    rng = np.random.default_rng(7)
    out = {}
    for (_, m), a in sorted(inputs.items(), key=lambda kv: (
            str(kv[0][0]), kv[0][1])):
        out.update(inverse_cases(lu, lu_cuda, a, rng, ("stage", "pivoting"),
                                 f" {path}"))
    for (dtype, m, kind), r in out.items():
        check(r["bit_equal"], f"inverse m={m} {dtype} {kind} ({path}) "
              "is not bit-equal to the plain version")
    return out


def phase_multiphase_device_vs_cpu(inpdir):
    """The multiphase port on the card (kernels) against the port on the
    CPU (plain versions): a midnight and a noon column, float64,
    MP_MINUTES minutes, the tiny grid and the small tot stand-in."""
    from mistra_tpu_torch import GridParams, Model
    from mistra_tpu_torch.chemistry.mech import write_synthetic_tot_mechanism
    out, wall = {}, {}
    with tempfile.TemporaryDirectory(prefix="mistra_tot_small_") as mtmp:
        write_synthetic_tot_mechanism(mtmp, *MP_CMP_MECH)
        cfg = multiphase_config(inpdir, mtmp, "float64",
                                grid=GridParams(**MP_CMP_GRID), zinv=100.0)
        for dev in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            model = Model(cfg, device=dev)
            state = midnight_and_noon(model)
            for _ in range(MP_MINUTES):
                state = model.minute_step(state)
            check_state(state, f"multiphase on {dev}")
            wall[dev] = time.perf_counter() - t0
            out[dev] = {k: v.cpu().numpy() for k, v in (
                ("t", state.met.t), ("xm1", state.met.xm1),
                ("ff", state.micro.ff), ("conc", state.chem.conc),
                ("photol_j", state.chem.photol_j),
                ("nonconv", state.chem.nonconv),
                ("cloud", state.chem.cloud))}
    ref, got = out["cpu"], out[DEVICE]
    check(float(ref["photol_j"][1].max()) > 0.0 == float(
        ref["photol_j"][0].max()), "noon/midnight J-rates")
    errs = {}
    for k, tol in MP_DEVICE_TOL.items():
        if k in ("conc", "photol_j"):
            errs[k] = rows_err(got[k], ref[k])
        else:
            errs[k] = float(np.abs(got[k] - ref[k]).max()
                            / np.abs(ref[k]).max())
        check(errs[k] <= tol, f"multiphase {k}: card vs CPU {errs[k]:.3e} > "
              f"{tol}")
    check(np.array_equal(got["nonconv"], ref["nonconv"]),
          f"nonconv card {got['nonconv']} cpu {ref['nonconv']}")
    cloud_diff = int((got["cloud"] != ref["cloud"]).sum())
    log(f"multiphase card vs cpu (2 columns at 00:00 and 12:00, float64, "
        f"{MP_MINUTES} minutes, grid {MP_CMP_GRID}, small tot stand-in "
        f"{MP_CMP_MECH}; card {wall[DEVICE]:.1f} s, cpu {wall['cpu']:.1f} s) "
        f"max rel err: "
        + ", ".join(f"{k} {v:.3e} (tol {MP_DEVICE_TOL[k]})"
                    for k, v in errs.items())
        + f"; nonconv card {got['nonconv'].tolist()} cpu "
        f"{ref['nonconv'].tolist()}; hysteresis flags differing "
        f"{cloud_diff}")
    return errs


def log_path(what, cfg, fig, extra=""):
    gp = cfg.grid
    log(f"{what}: {fig['columns']} columns x {fig['minutes']} minutes, "
        f"{cfg.dtype}, grid n={gp.n} nf={gp.nf} nka={gp.nka} nkt={gp.nkt}; "
        f"minute step {[round(t, 1) for t in fig['minute_ms']]} ms, steady "
        f"{fig['steady_minute_ms']:.1f} ms = "
        f"{fig['column_minutes_per_s']:.2f} column-minutes/s; "
        f"{fig['ros3_iterations']} Ros3 iterations, nonconv "
        f"{fig['nonconv']}; launches {fig['launches']}{extra}")


def path_config(inpdir, mechdir, settings, dtype, grid=None):
    """The configuration of one of phases 12-15's paths: settings on GRID
    (or grid)."""
    from mistra_tpu_torch import GridParams, MistraConfig
    return MistraConfig(grid=grid or GRID or GridParams(), dtype=dtype,
                        inpdir=inpdir, mechdir=mechdir, **settings)


def phase_nucleation(inpdir, gasdir, bott_cuda, lu_cuda, chem_t):
    """The nucleation column on the card: the chem=T minute (phase 8)
    with nuc=T, napari and lovejoy (appnucl2) and ifeed=1, NUC_COLUMNS
    columns half at noon, float32, MODE_MINUTES minutes; the particles
    that nucleation added per column are summed over every call."""
    from mistra_tpu_torch import Model
    cfg = path_config(inpdir, gasdir, NUC, "float32")
    model = Model(cfg, device=DEVICE)
    B = NUC_COLUMNS
    state = midnight_and_noon(model, B)
    nuc, drv = model._nucleation, model._chemistry
    check(nuc is not None, "no nucleation driver")
    vapors = [v[0] for v in nuc.vapors]
    added = torch.zeros(B, dtype=torch.float64, device=DEVICE)

    def counted(st, dt):
        out, diag = nuc(st, dt)
        j_app = diag["xn_app"]
        added.add_(torch.where(j_app > 0.1, j_app * dt, 0.0).sum(1).double())
        return out, diag

    model._nucleation = counted
    try:
        state, times, counts, solves = run_minutes(
            model.minute_step, state, MODE_MINUTES, (drv.kernel,), bott_cuda,
            lu_cuda)
    finally:
        model._nucleation = nuc
    iters = loop_iterations(solves)
    check_state(state, "nucleation column")
    check_launches("nucleation column", counts, iters, bott=True)
    columns = int((added > 0.0).sum())
    check(columns > 0, "nucleation added no particles in any column")
    fig = minute_figures(B, times, counts, iters,
                         int(state.chem.nonconv.sum()))
    fig.update(vapors=vapors, nucleating_columns=columns,
               nucleated_per_cm3_max=float(added.max()),
               chem_t_steady_minute_ms=chem_t["steady_minute_ms"])
    log_path("nucleation column (chem=T nkc_l=0, nuc=T, napari + lovejoy, "
             "ifeed=1)", cfg, fig,
             f"; vapors {vapors}; nucleation added particles in {columns} "
             f"of {B} columns (up to {fig['nucleated_per_cm3_max']:.3e} "
             f"/cm3 in one column, summed over its levels and substeps); "
             f"the chem=T minute (phase 8) steady "
             f"{chem_t['steady_minute_ms']:.1f} ms")
    profile_minute("nucleation column", model.minute_step, state, fig)
    return counts, fig


def chamber_dat_dir(inpdir):
    """inpdir/photolys with $INPDIR's chamber.dat linked there where it has
    one, else the synthetic stand-in written there (unless it holds one
    already)."""
    from mistra_tpu_torch.boxmodel import write_synthetic_chamber_dat
    phot = os.path.join(inpdir, "photolys")
    os.makedirs(phot, exist_ok=True)
    if os.path.exists(os.path.join(phot, "chamber.dat")):
        return phot
    ref = os.path.join(os.environ.get("INPDIR") or "", "photolys",
                       "chamber.dat")
    if os.environ.get("INPDIR") and os.path.exists(ref):
        os.symlink(os.path.abspath(ref), os.path.join(phot, "chamber.dat"))
        log(f"chamber.dat: the reference's, from INPDIR ({ref})")
    else:
        write_synthetic_chamber_dat(phot)
        log("chamber.dat: synthetic stand-in (INPDIR lacks "
            "photolys/chamber.dat)")
    return phot


def box_state(bm, B):
    """B boxes (half at noon) or, in chamber mode, B chambers with the
    clock at CHAMBER_START_S."""
    state = bm.init_state(B)
    if bm.cfg.chamber:
        return state.replace(tim=state.tim.replace(
            time=torch.full_like(state.tim.time, CHAMBER_START_S)))
    return midnight_and_noon(bm.model, B, state)


def phase_box(inpdir, totdir, gasdir, bott_cuda, lu_cuda):
    """Box and chamber on the card: BOX_COLUMNS boxes of BOX (the tot
    solve at the box level: integrate_box) and BOX_COLUMNS chambers of
    CHAMBER (mic=F, the gas-phase driver over the whole column), float32,
    MODE_MINUTES minutes each, launches counted; the chambers' J-rates are
    zero after the first minute (14 min) and the measured ones after the
    second (15 min).  Returns the launch counts, the figures and the
    inputs of the box's first inverse launches."""
    from mistra_tpu_torch.boxmodel import N_BL, BoxModel
    out, counts = {}, {}
    cfg = path_config(inpdir, totdir, BOX, "float32")
    bm = BoxModel(cfg, device=DEVICE)
    state = box_state(bm, BOX_COLUMNS)
    drv = bm.model._chemistry
    check(type(drv).__name__ == "MultiphaseDriver", f"box driver {drv}")
    inputs = capture_inverse_inputs(
        lambda: drv.integrate_box(state, DT, N_BL))
    state, times, counts["box"], solves = run_minutes(
        bm.minute_step, state, MODE_MINUTES, (drv.tot_kernel,), bott_cuda,
        lu_cuda)
    iters = loop_iterations(solves)
    check_state(state, "box")
    check_launches("box", counts["box"], iters, bott=False)
    out["box"] = minute_figures(BOX_COLUMNS, times, counts["box"], iters,
                                int(state.chem.nonconv.sum()))
    shapes = sorted((str(a.dtype), tuple(a.shape)) for a in inputs.values())
    log_path(f"box (nkc_l=4, nlevbox={cfg.nlevbox}, z_box {bm.z_box:.1f} m, "
             f"the tot solve at the box level)", cfg, out["box"],
             f"; the inverse's shapes {shapes}")
    profile_minute("box", bm.minute_step, state, out["box"])
    del bm, state

    chamber_dat_dir(inpdir)
    cfg = path_config(inpdir, gasdir, CHAMBER, "float32")
    bm = BoxModel(cfg, device=DEVICE)
    state = box_state(bm, BOX_COLUMNS)
    drv = bm.model._chemistry
    check(type(drv).__name__ == "ChemistryDriver", f"chamber driver {drv}")
    _, _, jmeas = bm.chamber_dat
    lit = {}

    def lights(minute, st):
        pj = st.chem.photol_j
        lit[minute] = bool((pj != 0.0).any())
        if minute == 1:
            for slot, val in jmeas.items():
                check(bool((pj[:, slot - 1] == np.float32(val)).all()),
                      f"chamber J slot {slot} is not the measured {val}")

    state, times, counts["chamber"], solves = run_minutes(
        bm.minute_step, state, MODE_MINUTES, (drv.kernel,), bott_cuda,
        lu_cuda, after_minute=lights)
    iters = loop_iterations(solves)
    check_state(state, "chamber")
    check(lit == {0: False, 1: True}, f"chamber lights {lit}")
    check_launches("chamber", counts["chamber"], iters, bott=False)
    out["chamber"] = minute_figures(BOX_COLUMNS, times, counts["chamber"],
                                    iters, int(state.chem.nonconv.sum()))
    log_path("chamber (Buxmann15_alpha settings, mic=F, the gas-phase "
             "driver)", cfg, out["chamber"],
             f"; J-rates zero at 14 min, the {len(jmeas)} measured slots "
             f"at 15 min")
    profile_minute("chamber (lights on)", bm.minute_step, state,
                   out["chamber"])
    return counts, out, inputs


def phase_soil(inpdir, gasdir, bott_cuda, lu_cuda):
    """The bare soil (isurf=1) on the card, SOIL_COLUMNS columns half at
    noon, float32, MODE_MINUTES minutes each: with mic=F and the gas-phase
    driver (SOIL_MIC_F), then with mic=T and chemistry off (SOIL); the
    soil's tb and eb moved and stayed finite."""
    from mistra_tpu_torch import Model
    out, counts = {}, {}
    for name, settings in (("soil mic=F", SOIL_MIC_F), ("soil", SOIL)):
        cfg = path_config(inpdir, gasdir, settings, "float32")
        model = Model(cfg, device=DEVICE)
        state = midnight_and_noon(model, SOIL_COLUMNS)
        tb0, eb0 = state.surf.tb.clone(), state.surf.eb.clone()
        drv = model._chemistry
        kernels = (drv.kernel,) if drv is not None else ()
        state, times, counts[name], solves = run_minutes(
            model.minute_step, state, MODE_MINUTES, kernels, bott_cuda,
            lu_cuda)
        iters = loop_iterations(solves)
        check_state(state, name)
        check(bool((state.surf.tb != tb0).any())
              and bool((state.surf.eb != eb0).any()),
              f"{name}: the soil did not move")
        check_launches(name, counts[name], iters, bott=cfg.mic)
        nonconv = int(state.chem.nonconv.sum()) if drv is not None else 0
        out[name] = minute_figures(SOIL_COLUMNS, times, counts[name], iters,
                                   nonconv)
        ts = state.met.t[:, 0]
        log_path(f"{name} (isurf=1, chem={cfg.chem})", cfg, out[name],
                 f"; surface temperature {ts.min().item():.2f}.."
                 f"{ts.max().item():.2f} K, top soil moisture "
                 f"{state.surf.eb[:, 0].min().item():.4f}.."
                 f"{state.surf.eb[:, 0].max().item():.4f}")
        profile_minute(name, model.minute_step, state, out[name])
    return counts, out


def phase_modes_device_vs_cpu(inpdir):
    """Each new path, and nucleation with the multiphase driver
    (NUC_MULTIPHASE), on the card (kernels) against the CPU (plain
    versions): two columns (a midnight and a noon column; chambers from
    CHAMBER_START_S, across the lights' edge), float64, MODE_MINUTES
    minutes, the tiny grid and small stand-ins."""
    from mistra_tpu_torch import BoxModel, GridParams, Model
    from mistra_tpu_torch.chemistry.mech import (
        write_synthetic_gas_mechanism, write_synthetic_tot_mechanism)
    grid = GridParams(**MP_CMP_GRID)
    chamber_dat_dir(inpdir)
    errs = {}
    with tempfile.TemporaryDirectory(prefix="mistra_modes_") as tmp:
        gas, tot = os.path.join(tmp, "gas"), os.path.join(tmp, "tot")
        os.makedirs(gas)
        os.makedirs(tot)
        write_synthetic_gas_mechanism(gas, MODES_CMP_GAS)
        write_synthetic_tot_mechanism(tot, *MP_CMP_MECH)
        paths = {"nucleation": (Model, gas, NUC),
                 "nucleation nkc_l=4": (Model, tot, NUC_MULTIPHASE),
                 "box": (BoxModel, tot, BOX),
                 "chamber": (BoxModel, gas, CHAMBER),
                 "soil mic=F": (Model, gas, SOIL_MIC_F),
                 "soil": (Model, gas, SOIL)}
        for name, (make, mech, settings) in paths.items():
            cfg = path_config(inpdir, mech, dict(settings, zinv=100.0),
                              "float64", grid)
            res, wall = {}, {}
            for dev in (DEVICE, "cpu"):
                t0 = time.perf_counter()
                m = make(cfg, device=dev)
                state = box_state(m, 2) if make is BoxModel \
                    else midnight_and_noon(m)
                for _ in range(MODE_MINUTES):
                    state = m.minute_step(state)
                check_state(state, f"{name} on {dev}")
                wall[dev] = time.perf_counter() - t0
                fields = [("t", state.met.t), ("xm1", state.met.xm1),
                          ("ff", state.micro.ff), ("tb", state.surf.tb),
                          ("eb", state.surf.eb)]
                if state.chem is not None:
                    fields += [("conc", state.chem.sgas),
                               ("nonconv", state.chem.nonconv)]
                res[dev] = {k: v.cpu().numpy() for k, v in fields}
            ref, got = res["cpu"], res[DEVICE]
            e = {}
            for k, tol in MODES_DEVICE_TOL.items():
                if k not in ref:
                    continue
                e[k] = rows_err(got[k], ref[k]) if k == "conc" else float(
                    np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max())
                check(e[k] <= tol, f"{name} {k}: card vs CPU {e[k]:.3e} > "
                      f"{tol}")
            check(np.array_equal(got.get("nonconv"), ref.get("nonconv")),
                  f"{name}: nonconv card {got.get('nonconv')} cpu "
                  f"{ref.get('nonconv')}")
            log(f"{name} card vs cpu (2 columns, float64, {MODE_MINUTES} "
                f"minutes, grid {MP_CMP_GRID}; card {wall[DEVICE]:.1f} s, "
                f"cpu {wall['cpu']:.1f} s) max rel err: "
                + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
                + f"; nonconv {ref.get('nonconv')}")
            errs[name] = e
    return errs


def cli_namelist(path, inpdir, settings, **extra) -> str:
    """A namelist of settings (a dict of config fields) with inpdir."""
    def value(v):
        if isinstance(v, bool):
            return ".true." if v else ".false."
        return f"'{v}'" if isinstance(v, str) else repr(v)
    items = dict(settings, inpdir=inpdir, **extra)
    body = ",\n".join(f"  {k} = {value(v)}" for k, v in items.items())
    Path(path).write_text(f"&mistra_cfg\n{body}\n/\n")
    return str(path)


def cli_config(nml):
    """The configuration the CLI runs for the namelist nml."""
    from mistra_tpu_torch import config_from_namelist
    from mistra_tpu_torch.cli import override_grid
    cfg = config_from_namelist(nml)
    if CLI_GRID:
        override_grid(cfg, CLI_GRID)
    return cfg


def cli_start(nml, minute, path):
    """A checkpoint of the namelist's initial state (one column, on the
    card) with the clock's minute set: the runs' start."""
    from mistra_tpu_torch import Model
    from mistra_tpu_torch.io.checkpoint import save_checkpoint
    state = Model(cli_config(nml), device=DEVICE).init_state(1)
    tim = state.tim.replace(lmin=torch.full_like(state.tim.lmin, minute))
    return save_checkpoint(path, state.replace(tim=tim))


def run_cli(what, args):
    """python -m mistra_tpu_torch args in a subprocess of this script:
    (its output, wall s, {timing and launches from its report})."""
    cmd = [sys.executable, "-m", "mistra_tpu_torch", *args]
    if CLI_GRID:
        cmd += ["--grid", CLI_GRID]
    if DEVICE == "cpu":
        cmd += ["--platform", "cpu"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"CLI {what} failed ({out.returncode}):\n"
          f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    rep = {"wall_s": wall}
    for line in out.stdout.splitlines():
        if line.startswith("run report: "):
            rep.update(json.loads(line[len("run report: "):]))
        elif line.startswith("writer: "):
            rep["writer"] = line[len("writer: "):]
    check("kernel_launches" in rep,
          f"CLI {what}: no report in\n{out.stdout[-3000:]}")
    rep["launches"] = rep.pop("kernel_launches")
    log(f"cli {what}: {rep}")
    return out.stdout, rep


def finite_text(path):
    text = Path(path).read_text()
    check(text.strip() != "", f"{path} is empty")
    low = text.lower()
    check("nan" not in low and "inf" not in low, f"{path}: not finite")
    return text


def check_cli_outputs(outdir, cfg, chem, hourly=True):
    """Every output file of a CLI run present and finite: the netCDF
    files (the numpy groups where the run took that writer), tima.out,
    the hourly profiles (where the run crossed an hour), the checkpoints
    and aerosol_final.npy; returns the number of 15-minute records."""
    from mistra_tpu_torch.io import netcdf as ncio
    from mistra_tpu_torch.io.output import read_output
    out = Path(outdir)
    g = cfg.grid
    files = ["tima.out", "restart.pt"]
    if hourly:
        files += ["profm.out", "profr.out"]
        files += ["mass.out", "profc.out"] if chem else []
    files += [] if chem else ["aerosol_final.npy"]
    for f in files:
        check((out / f).exists(), f"CLI output {f} missing in {outdir}")
    for f in files:
        if f.endswith(".out"):
            finite_text(out / f)
    for ck in out.glob("restart*.pt"):
        for k, v in torch.load(ck, weights_only=True)["fields"].items():
            check(not v.is_floating_point() or bool(torch.isfinite(v).all()),
                  f"{ck.name}: non-finite {k}")
    if not chem:
        check(bool(np.isfinite(np.load(out / "aerosol_final.npy")).all()),
              "aerosol_final.npy not finite")
    checked = []
    if (out / "meteo.nc").exists():
        r = ncio.NcReader(str(out / "meteo.nc"))
        records = r.dimlen("time")
        r.close()
        shapes = {
            "meteo.nc": {"t": ("T", g.n), "xm1": ("T", g.n),
                         "dtrad": ("T", g.n), "time": ("T",)},
            "mic.nc": {"fsum": ("T", g.n),
                       "part1D": ("T", g.nka - 1, g.nf)},
            "part.nc": {"ff": ("T", g.nkt, g.nka, g.n)}}
        if chem:
            nspec = len(finite_text(out / "species.txt").split())
            nch = len(finite_text(out / "s_channels.txt").splitlines())
            shapes.update({
                "chem.nc": {"conc": ("T", nspec, g.n)},
                "jrat.nc": {"photol_j": ("T", ncio.NPHRXN, g.n)},
                "rxn.nc": {"level_index": (len(ncio.budget_levels(cfg)),),
                           "s_channel_rxn": (nch,)}})
        for name, vs in shapes.items():
            r = ncio.NcReader(str(out / name))
            for k, shape in vs.items():
                T = r.dimlen("time") if "T" in shape else 0
                check("T" not in shape or T > 0, f"{name}: no record")
                a = r.get(k, tuple(T if d == "T" else d for d in shape))
                check(bool(np.isfinite(a).all()), f"{name}:{k} not finite")
                checked.append(f"{name}:{k}{list(a.shape)}")
            r.close()
    else:
        groups = read_output(str(out / "output"))
        records = len(groups["met"]["time"])
        want = {"grid", "met", "mic"} | ({"chem_gas", "jrate", "rxn"}
                                         if chem else set())
        check(want <= set(groups), f"numpy groups {sorted(groups)}")
        for gname, ds in groups.items():
            for k, a in ds.items():
                if a.dtype.kind in "fi":
                    check(bool(np.isfinite(a).all()),
                          f"{gname}/{k} not finite")
                    checked.append(f"{gname}/{k}{list(a.shape)}")
    log(f"cli outputs of {outdir}: {len(files)} files and "
        f"{len(checked)} datasets present and finite, {records} records: "
        f"{checked}")
    return records


def phase_cli(inpdir, totdir):
    """The run harness on the card: runs (a)-(d) of CLI_* above, each
    ``python -m mistra_tpu_torch`` in a subprocess; every output present
    and finite, the restart run within CLI_RESTART_TOL of the run in one
    piece, each run's kernel launches as the CLI counted them (dwsum,
    advect and sedp's sedimentation kernel launched, and with the
    multiphase chemistry the inverse and sedl's), its seconds per
    minute and host ms per snapshot and per checkpoint, the writer taken
    and the profiler trace's dwsum events."""
    from mistra_tpu_torch.io import netcdf as ncio
    res = {"libnetcdf": ncio.available(),
           "netcdf_unavailable": ncio.unavailable_reason()}
    log(f"cli: native netCDF writer available on this host: "
        f"{res['libnetcdf']} {res['netcdf_unavailable']}")
    with tempfile.TemporaryDirectory(prefix="mistra_cli_") as tmp:
        d = Path(tmp)
        nml = cli_namelist(d / "btz96.nml", inpdir,
                           dict(BTZ96, dtype="float32"), nhour=CLI_NHOUR)
        cfg = cli_config(nml)
        start = cli_start(nml, CLI_START_MINUTE, str(d / "start.pt"))
        # (a) from 11:31 for 31 minutes
        _, res["a"] = run_cli("(a) BTZ96 31 minutes", [
            "--namelist", nml, "--outdir", str(d / "a"), "--restart", start,
            "--minutes", str(CLI_MINUTES)])
        check(check_cli_outputs(d / "a", cfg, chem=False) == 3,
              "(a): the initial record and the 15- and 30-minute "
              "snapshots expected")
        check(res["a"]["snapshots_ff"] == 1 == res["a"]["snapshots_no_ff"],
              f"(a): one snapshot with ff and one without expected: "
              f"{res['a']}")
        noon = d / "a" / f"restart_day0_{CLI_NHOUR + 1:02d}h.pt"
        check(noon.exists(), f"no 12:00 checkpoint {noon}")
        check(finite_text(d / "a" / "profm.out").count("# day") == 1,
              "one hourly profile block expected")
        for k in ("bott_dwsum", "bott_advect", "sed_advect"):
            check(res["a"]["launches"][k] > 0, f"(a): {k} not launched")
        check(res["a"]["launches"]["sed_splits"] == 0,
              "(a): sedl's kernel launched without chemistry")
        check(not any(res["a"]["ros3"].values()),
              f"(a): Ros3 counts {res['a']['ros3']} without chemistry")
        # (b) 2 minutes from (a)'s 12:00 checkpoint
        _, res["b"] = run_cli("(b) restart 2 minutes", [
            "--namelist", nml, "--outdir", str(d / "b"), "--restart",
            str(noon), "--minutes", str(CLI_RESTART_MINUTES)])
        check_cli_outputs(d / "b", cfg, chem=False, hourly=False)
        whole = torch.load(d / "a" / "restart.pt", weights_only=True)
        split = torch.load(d / "b" / "restart.pt", weights_only=True)
        check(whole["fields"].keys() == split["fields"].keys(),
              "restart: field sets differ")
        worst, equal = 0.0, True
        for k, a in whole["fields"].items():
            b = split["fields"][k]
            equal = equal and torch.equal(a, b)
            a64, b64 = a.double(), b.double()
            scale = max(float(a64.abs().max()), 1e-300) if a.numel() else 1
            err = float((a64 - b64).abs().max()) / scale if a.numel() else 0
            check(err <= CLI_RESTART_TOL, f"restart {k}: {err:.3e} > "
                  f"{CLI_RESTART_TOL:.0e}")
            worst = max(worst, err)
        res["restart"] = {"max_rel_err": worst, "bit_equal": equal}
        log(f"cli restart: (b) from the 12:00 checkpoint against (a) in one "
            f"piece, largest field error {worst:.3e} of scale, bit-equal "
            f"{equal}")
        # (c) multiphase chem=T with binout from 11:59 for 2 minutes
        cnml = cli_namelist(d / "multiphase.nml", inpdir,
                            dict(MULTIPHASE, dtype="float32", binout=True,
                                 mechdir=totdir), nhour=CLI_NHOUR)
        ccfg = cli_config(cnml)
        cstart = cli_start(cnml, CLI_CHEM_START_MINUTE,
                           str(d / "cstart.pt"))
        _, res["c"] = run_cli("(c) multiphase 2 minutes", [
            "--namelist", cnml, "--outdir", str(d / "c"), "--restart",
            cstart, "--minutes", str(CLI_CHEM_MINUTES)])
        check_cli_outputs(d / "c", ccfg, chem=True)
        for k in ("bott_dwsum", "bott_advect", "batched_inv", "sed_advect",
                  "sed_splits"):
            check(res["c"]["launches"][k] > 0, f"(c): {k} not launched")
        # the tot and the gas-above solves, each captured once
        ros3 = res["c"]["ros3"]
        check(ros3["ros3.iters"] > 0 and ros3["ros3.graph_captures"] == 2
              and ros3["ros3.graph_iters"] == ros3["ros3.iters"] - 2
              and res["c"]["launches"]["batched_inv"]
              == 2 * ros3["ros3.iters"], f"(c): Ros3 counts {ros3}")
        # (d) --profile: minutes 2-4 traced
        _, res["d"] = run_cli("(d) profile 4 minutes", [
            "--namelist", nml, "--outdir", str(d / "d"), "--restart", start,
            "--minutes", str(CLI_PROFILE_MINUTES), "--profile",
            str(d / "trace")])
        check_cli_outputs(d / "d", cfg, chem=False, hourly=False)
        traces = list((d / "trace").glob("trace_*.json"))
        check(len(traces) == 1, f"profile: traces {traces}")
        blob = traces[0].read_bytes()
        res["d"]["trace_mb"] = len(blob) / 1e6
        # kernel events carry the kernel's signature ("void
        # bott_dwsum_kernel<float>(...)")
        res["d"]["dwsum_events"] = blob.count(b"bott_dwsum_kernel")
        log(f"cli profile: trace {res['d']['trace_mb']:.1f} MB, "
            f"{res['d']['dwsum_events']} bott_dwsum_kernel events")
        check(res["d"]["dwsum_events"] > 0, "profile: no bott_dwsum_kernel")
    log(f"cli summary ({card_line()}): writer {res['a']['writer']}; s per "
        + ", ".join(f"minute ({k}) {res[k]['s_per_minute']:.3f}"
                    for k in "abcd")
        + f"; snapshot: initial record {res['a']['snapshot_initial_ms']:.3f}"
        f" ms, with ff {res['a']['snapshot_ff_ms']:.3f} ms, without "
        f"{res['a']['snapshot_no_ff_ms']:.3f} ms, checkpoint "
        f"{res['a']['checkpoint_ms']:.3f} ms (a)")
    return res


def tp_backend() -> str:
    """nccl with one card per rank where the host has TP cards, else
    gloo with every rank on cuda:0 (NCCL refuses two ranks on one card;
    gloo's all_reduce takes CUDA tensors through the host)."""
    return "nccl" if torch.cuda.device_count() >= TP else "gloo"


def tp_devices() -> list:
    count = torch.cuda.device_count()
    return [f"cuda:{r % count}" for r in range(TP)]


def tp_run(model, m, state, kernels, bott_cuda, lu_cuda):
    """TP_MINUTES minutes of this rank's share through the ensemble step
    of mesh m, every kernel's counter and the all_reduce counter set to 0
    just before and read just after; returns (state, figures)."""
    import torch.distributed as dist
    from mistra_tpu_torch.parallel import mesh
    step = mesh.make_ensemble_step(model, m)
    dist.barrier()
    model.bins.reset_counts()
    state, times, counts, solves = run_minutes(
        step, state, TP_MINUTES, kernels, bott_cuda, lu_cuda)
    b = model.bins
    calls, seconds, nbytes = b.calls, b.seconds, b.bytes
    check_state(state, f"tp rank {m.rank}")
    fig = minute_figures(state.met.t.shape[0], times, counts,
                         loop_iterations(solves), None)
    fig.update(allreduce_calls=calls,
               allreduce_per_minute=calls / TP_MINUTES,
               allreduce_bytes_per_minute=nbytes / TP_MINUTES,
               allreduce_host_ms_per_minute=1e3 * seconds / TP_MINUTES)
    return state, fig


def tp_compare_runs(cmp, m, model_of):
    """Each of cmp's {what: (cfg, flattened global start state)} one
    minute through the ensemble step of mesh m on this rank's share;
    returns {what: {"allreduce_calls", "gathered" (rank 0 only)}}
    (gather_state raises unless the replicated fields agree across the
    ranks)."""
    from mistra_tpu_torch.io.checkpoint import flatten_state
    from mistra_tpu_torch.parallel import mesh
    out = {}
    for what, (cfg, flat) in cmp.items():
        model, stepper = model_of(cfg)
        start = stepper.init_state(1).map_paths(lambda p, _x: flat[p])
        model.bins.reset_counts()
        state = mesh.make_ensemble_step(stepper, m)(
            mesh.shard_state(start, m))
        end = mesh.gather_state(state, m)
        out[what] = {"allreduce_calls": model.bins.calls,
                     "gathered": flatten_state(end) if m.rank == 0
                     else None}
    return out


def tp_rank(rank, job):
    """One rank of phase 17 (a spawned process; the mesh is dp = 1, tp =
    TP): joins the process group, runs (a)-(e) on its share and writes
    its figures, and rank 0 the gathered end states of (c) and (e), to
    job["out"]/rank<r>.pt; a traceback to rank<r>.err where it fails
    (then exits non-zero)."""
    import traceback

    import torch.distributed as dist
    out = os.path.join(job["out"], f"rank{rank}")
    try:
        from mistra_tpu_torch import BoxModel, Model
        from mistra_tpu_torch.chemistry import lu_cuda
        from mistra_tpu_torch.kernels import build
        from mistra_tpu_torch.parallel import mesh
        from mistra_tpu_torch.physics import bott_cuda
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # the parent built the library: a rank only loads it
        check(build.library_path().exists(), "kernel library not built")
        build.load_library()
        mesh.init_distributed(job["init"], TP, rank, backend=job["backend"],
                              timeout_s=TP_COLLECTIVE_TIMEOUT_S)
        m = mesh.make_mesh(tp=TP, devices=job["devices"])
        torch.cuda.set_device(m.device)

        def model_of(cfg):
            """(Model, stepper): the BoxModel's for a box or chamber."""
            bins = m.bins(cfg.grid.nka)
            if cfg.box or cfg.chamber:
                box = BoxModel(cfg, device=m.device, bins=bins)
                return box.model, box
            model = Model(cfg, device=m.device, bins=bins)
            return model, model

        # (a), (b): the initial state of this rank's bins (init_state
        # builds the whole column and cuts it); gather_state raises unless
        # the replicated fields agree across the ranks
        model, _ = model_of(job["btz96"])
        res = {"device": str(m.device), "bins": (model.bins.lo,
                                                 model.bins.hi)}
        state, res["a"] = tp_run(model, m, model.init_state(TP_COLUMNS), (),
                                 bott_cuda, lu_cuda)
        mesh.gather_state(state, m)
        model, _ = model_of(job["chem_t"])
        state = midnight_and_noon(model, TP_COLUMNS)
        state, res["b"] = tp_run(model, m, state, (model._chemistry.kernel,),
                                 bott_cuda, lu_cuda)
        res["b"]["nonconv"] = int(state.chem.nonconv.sum())
        mesh.gather_state(state, m)
        # (d): the multiphase minute, both Ros3 solves counted
        model, _ = model_of(job["multiphase"])
        state = midnight_and_noon(model, MP_COLUMNS)
        drv = model._chemistry
        state, res["d"] = tp_run(model, m, state,
                                 (drv.tot_kernel, drv.kernel), bott_cuda,
                                 lu_cuda)
        res["d"]["nonconv"] = int(state.chem.nonconv.sum())
        mesh.gather_state(state, m)
        del model, drv, state
        # (c), (e): the parent's global start states, shared out
        res["c"] = tp_compare_runs(job["cmp"], m, model_of)
        res["e"] = tp_compare_runs(job["cmp_e"], m, model_of)
        torch.cuda.synchronize()
        torch.save(res, out + ".pt")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_tp_ranks(job) -> list:
    """Phase 17's ranks as spawned processes; each one's result, in rank
    order.  Fails if a rank failed or is still running after TP_JOIN_S
    (then killed)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=tp_rank, args=(r, job)) for r in range(TP)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TP_JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in late:
        procs[r].kill()
        procs[r].join(30.0)
    errors = ""
    for r in range(TP):
        err = os.path.join(job["out"], f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors += f"\nrank {r}:\n{f.read()}"
    check(not late, f"tp ranks {late} still running after {TP_JOIN_S} s"
          + errors)
    codes = [p.exitcode for p in procs]
    check(not any(codes), f"tp rank exit codes {codes}" + errors)
    return [torch.load(os.path.join(job["out"], f"rank{r}.pt"),
                       weights_only=False) for r in range(TP)]


def tp_start_states(cfgs):
    """{what: (cfg, flattened global start state on the CPU)} and {what:
    its end after one tp=1 minute on the card} of cfgs {what: cfg}: two
    columns (a midnight and a noon one; chambers from CHAMBER_START_S)."""
    from mistra_tpu_torch import BoxModel, Model
    from mistra_tpu_torch.io.checkpoint import flatten_state
    cmp, ref_end = {}, {}
    for what, cfg in cfgs.items():
        if cfg.box or cfg.chamber:
            stepper = BoxModel(cfg, device=DEVICE)
            start = box_state(stepper, 2)
        else:
            stepper = Model(cfg, device=DEVICE)
            start = midnight_and_noon(stepper)
        cmp[what] = (cfg, {k: v.cpu()
                           for k, v in flatten_state(start).items()})
        ref_end[what] = {k: v.cpu() for k, v in
                         flatten_state(stepper.minute_step(start)).items()}
    return cmp, ref_end


def tp_check_launches(r, what, fig, tp1, newton_flips=0):
    """Rank r's launches in a minute run of phase 17: dwsum as tp=1's,
    give or take newton_flips (subkon's Newton loop launches it once per
    iteration, and its exit test reads sums over the bins whose order
    differs from tp=1's), advect once per substep, the inverse twice per
    Ros3 iteration of the rank's own (replicated) solves, the
    sedimentation kernel at least once per substep (once per pass of the
    rank's own sedp loop, which ``run_minutes`` checked) and its splits as
    tp=1's (once per sedl call)."""
    la, l1 = fig["launches"], tp1["launches"]
    check(abs(la["bott_dwsum"] - l1["bott_dwsum"]) <= newton_flips,
          f"tp rank {r} {what}: dwsum {la['bott_dwsum']} launches, tp=1 "
          f"{l1['bott_dwsum']} (at most {newton_flips} apart)")
    check(la["bott_advect"] == 6 * TP_MINUTES,
          f"tp rank {r} {what}: advect {la['bott_advect']}")
    check(la["batched_inv"] == 2 * fig["ros3_iterations"],
          f"tp rank {r} {what}: batched_inv {la['batched_inv']} for "
          f"{fig['ros3_iterations']} Ros3 iterations")
    check(la["sed_advect"] >= 6 * TP_MINUTES
          and la["sed_splits"] == l1["sed_splits"],
          f"tp rank {r} {what}: sedimentation launches {la} (tp=1 {l1})")
    check(fig["allreduce_calls"] > 0, f"tp rank {r} {what}: no all_reduce")


def tp_shared(fig, k):
    """fig[k] as every rank's should read: the launches without
    sed_advect, whose count follows sedp's passes over the rank's own
    bins."""
    if k == "launches":
        return {n: c for n, c in fig[k].items() if n != "sed_advect"}
    return fig[k]


def tp_log_rank(fig, tp1):
    """A rank's figures of a minute run beside tp=1's."""
    return (f"minute {[round(t, 1) for t in fig['minute_ms']]} ms, "
            f"steady {fig['steady_minute_ms']:.1f} (tp=1 "
            f"{[round(t, 1) for t in tp1['minute_ms']]}, steady "
            f"{tp1['steady_minute_ms']:.1f}), launches {fig['launches']} "
            f"(tp=1 {tp1['launches']}), {fig['ros3_iterations']} Ros3 "
            f"iterations (tp=1 {tp1['ros3_iterations']}), nonconv "
            f"{fig['nonconv']} (tp=1 {tp1['nonconv']}), all_reduce "
            f"{fig['allreduce_per_minute']:.1f} per minute, "
            f"{fig['allreduce_bytes_per_minute'] / 1e6:.3f} MB and "
            f"{fig['allreduce_host_ms_per_minute']:.2f} host ms per minute")


def tp_compare(what, want, got, calls, part):
    """(c)/(e): the gathered end state of one path against tp=1 at
    TP_TOL, every rank with the same all_reduce calls; returns the
    figures."""
    paths = tuple(p for p in TP_FIELDS + TP_ROWS if p in want)
    errs = {p: tp_rel_err(want[p], got[p], rows=p in TP_ROWS)
            for p in paths}
    for p, e in errs.items():
        check(e <= TP_TOL, f"{what} ({part}) tp={TP} vs tp=1 {p}: "
              f"{e:.3e} > {TP_TOL}")
    bit_equal = [k for k in want if torch.equal(want[k], got[k])]
    check(calls[0] > 0 and len(set(calls)) == 1,
          f"{what} ({part}): all_reduce calls {calls}")
    log(f"{what} ({part}) tp={TP} vs tp=1 on the card ({card_line()}; 2 "
        f"columns, float64, 1 minute, gathered from the ranks; the "
        f"replicated fields bit-equal across the ranks) max rel err: "
        + ", ".join(f"{p} {e:.3e}" for p, e in errs.items())
        + f"; {len(bit_equal)} of {len(want)} fields bit-equal to tp=1"
        f"; {calls[0]} all_reduce calls per rank")
    return {"max_rel_err": errs, "fields_bit_equal_to_tp1": len(bit_equal),
            "fields": len(want), "allreduce_calls": calls}


def phase_tp(inpdir, gasdir, totdir, bott_cuda, lu_cuda, mp_tp1=None):
    """The tp split on the card: the paths of (a)-(e) at tp=1 in this
    process (for (d) phase 10's figures, mp_tp1, where given), then at
    tp=TP in spawned ranks on the backend of ``tp_backend``; checks each
    rank's launches against tp=1, (c)'s and (e)'s gathered states
    against tp=1 at TP_TOL and the replicated fields bit-equal across
    the ranks (``gather_state`` raises otherwise).  Returns the
    figures."""
    from mistra_tpu_torch import GridParams, Model
    from mistra_tpu_torch.chemistry.mech import (
        write_synthetic_gas_mechanism, write_synthetic_tot_mechanism)
    backend, devices = tp_backend(), tp_devices()
    log(f"phase 17: tp={TP} ranks on {devices} over {backend} "
        f"({torch.cuda.device_count()} cards visible)")
    cfgs = {"btz96": model_config(inpdir, "float32"),
            "chem_t": chem_t_config(inpdir, gasdir, "float32"),
            "multiphase": multiphase_config(inpdir, totdir, "float32")}
    ref = {}
    model = Model(cfgs["btz96"], device=DEVICE)
    _, times, counts, _ = run_minutes(
        model.minute_step, model.init_state(TP_COLUMNS), TP_MINUTES, (),
        bott_cuda, lu_cuda)
    ref["a"] = minute_figures(TP_COLUMNS, times, counts, 0, None)
    model = Model(cfgs["chem_t"], device=DEVICE)
    state = midnight_and_noon(model, TP_COLUMNS)
    state, times, counts, solves = run_minutes(
        model.minute_step, state, TP_MINUTES, (model._chemistry.kernel,),
        bott_cuda, lu_cuda)
    ref["b"] = minute_figures(TP_COLUMNS, times, counts,
                              loop_iterations(solves),
                              int(state.chem.nonconv.sum()))
    ref["d"] = mp_tp1
    check(mp_tp1 is None or (mp_tp1["minutes"], mp_tp1["columns"])
          == (TP_MINUTES, MP_COLUMNS), "phase 10's run is not (d)'s tp=1")
    if mp_tp1 is None:
        model = Model(cfgs["multiphase"], device=DEVICE)
        state = midnight_and_noon(model, MP_COLUMNS)
        drv = model._chemistry
        state, times, counts, solves = run_minutes(
            model.minute_step, state, TP_MINUTES,
            (drv.tot_kernel, drv.kernel), bott_cuda, lu_cuda)
        check_state(state, "tp=1 multiphase minute")
        ref["d"] = minute_figures(MP_COLUMNS, times, counts,
                                  loop_iterations(solves),
                                  int(state.chem.nonconv.sum()))
        check_launches("tp=1 multiphase minute", counts,
                       ref["d"]["ros3_iterations"], bott=True,
                       minutes=TP_MINUTES, sedl=True)
        del model, drv, state
    cmp, ref_end = tp_start_states(
        {"BTZ96": model_config(inpdir, "float64"),
         "chem=T": chem_t_config(inpdir, gasdir, "float64")})
    torch.cuda.synchronize()

    chamber_dat_dir(inpdir)
    with tempfile.TemporaryDirectory(prefix="mistra_tp_") as tmp:
        mech = {"gas": os.path.join(tmp, "gas"),
                "tot": os.path.join(tmp, "tot")}
        for d in mech.values():
            os.makedirs(d)
        write_synthetic_gas_mechanism(mech["gas"], MODES_CMP_GAS)
        write_synthetic_tot_mechanism(mech["tot"], *MP_CMP_MECH)
        cmp_e, ref_end_e = tp_start_states({
            what: path_config(inpdir, mech[kind], dict(settings, zinv=100.0),
                              "float64", GridParams(**MP_CMP_GRID))
            for what, (kind, settings) in TP_PATHS.items()})
        torch.cuda.synchronize()
        job = dict(cfgs, backend=backend, devices=devices, out=tmp,
                   init=f"file://{tmp}/init", cmp=cmp, cmp_e=cmp_e)
        ranks = spawn_tp_ranks(job)

    out = {"backend": backend, "devices": devices, "tp": TP,
           "columns": TP_COLUMNS, "multiphase_columns": MP_COLUMNS,
           "minutes": TP_MINUTES, "tp1": ref, "ranks": []}
    for r, res in enumerate(ranks):
        a, b, d = res["a"], res["b"], res["d"]
        log(f"tp rank {r} ({res['device']}, dry bins {res['bins']}): "
            f"BTZ96 {TP_COLUMNS} columns float32 "
            + tp_log_rank(a, ref["a"])
            + f"; chem=T {TP_COLUMNS} columns "
            + tp_log_rank(b, ref["b"])
            + f"; multiphase {MP_COLUMNS} columns (float32 state, float64 "
            f"tot) " + tp_log_rank(d, ref["d"]))
        for what, fig, tp1, flips in (
                ("BTZ96", a, ref["a"], 0), ("chem=T", b, ref["b"], 0),
                ("multiphase", d, ref["d"], TP_MP_NEWTON_FLIPS)):
            tp_check_launches(r, what, fig, tp1, flips)
        check(b["ros3_iterations"] > 0 and d["ros3_iterations"] > 0,
              f"tp rank {r}: no Ros3 iterations")
        check(a["launches"]["batched_inv"] == 0, f"tp rank {r}: BTZ96 "
              "launched the inverse")
        for k in ("launches", "allreduce_calls", "allreduce_bytes_per_minute",
                  "ros3_iterations", "nonconv"):
            check(all(tp_shared(x, k) == tp_shared(ranks[0][p], k)
                      for p, x in (("a", a), ("b", b), ("d", d))),
                  f"tp ranks 0 and {r} differ in {k}")
        out["ranks"].append({"rank": r, "device": res["device"],
                             "bins": res["bins"], "btz96": a, "chem_t": b,
                             "multiphase": d})

    out["cmp"] = {what: tp_compare(what, want, ranks[0]["c"][what]["gathered"],
                                   [r["c"][what]["allreduce_calls"]
                                    for r in ranks], "c")
                  for what, want in ref_end.items()}
    out["cmp_tiny"] = {
        what: tp_compare(what, want, ranks[0]["e"][what]["gathered"],
                         [r["e"][what]["allreduce_calls"] for r in ranks],
                         "e")
        for what, want in ref_end_e.items()}
    return out


def tp_rel_err(want, got, rows=False) -> float:
    """max |got - want| over want's largest magnitude; with rows ([B,
    rows, n]) each row's over its own, an absolute difference where a row
    is zero everywhere."""
    want, got = want.double(), got.double()
    if rows:
        scale = want.abs().amax(dim=(0, 2))
        diff = (got - want).abs().amax(dim=(0, 2))
        return float(torch.where(scale > 0, diff / scale.clamp(
            min=1e-300), diff).max())
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale > 0 else diff


def ptxas_report(text: str) -> dict:
    """{mangled kernel name: {registers, stack, spill_stores, spill_loads}}
    from nvcc -Xptxas -v output."""
    import re
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def check_ptxas(text: str) -> None:
    """Logs each kernel's registers and spills; fails if a variant of the
    inverse on a chemistry path spills: float64 m = 80 and 101 (the tot
    solve, phase 6), m = 4 and 95 in float32 and float64 (the chem=T
    minute and its card-vs-CPU run, phases 8-9); phase 10 adds its own
    (check_spills)."""
    if not text:
        log("ptxas: library loaded from the build cache, no log")
        return
    import re
    for name, r in sorted(ptxas_report(text).items()):
        hit = re.search(r"\d+((?:gj_inverse|bott|sed)\w*)", name)
        short = hit.group(1) if hit else name
        log(f"ptxas: {short[:70]}: "
            f"{r.get('registers')} registers, {r.get('stack')} B stack, "
            f"{r.get('spill_stores')} / {r.get('spill_loads')} B spill "
            f"stores / loads")
    check_spills(text, ((80, torch.float64), (101, torch.float64),
                        (4, torch.float32), (95, torch.float32),
                        (4, torch.float64), (95, torch.float64)))


def check_spills(text: str, variants) -> None:
    """Fails unless ptxas compiled the inverse's variant for each (m,
    dtype) of variants once, without a spill."""
    if not text:
        return
    from mistra_tpu_torch.chemistry import lu_cuda
    rep = ptxas_report(text)
    for m, dtype in variants:
        p = lu_cuda.launch_plan(m, dtype)
        t = "d" if dtype == torch.float64 else "f"
        key = f"gj_inverse_kernelI{t}Li{p.tx}ELi{p.ry}ELi{p.rx}E"
        hits = [r for n, r in rep.items() if key in n]
        check(len(hits) == 1, f"ptxas: no single entry for {key}")
        check(hits[0].get("spill_stores") == 0 == hits[0].get("spill_loads"),
              f"ptxas: {key} spills: {hits[0]}")
        log(f"ptxas: m={m} {str(dtype).replace('torch.', '')} ({key}) "
            f"compiled once, no spill")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the port and its kernel sources come from this checkout, not from an
    # installed copy
    import mistra_tpu_torch
    from mistra_tpu_torch.kernels import build
    from mistra_tpu_torch.physics import bott_cuda, growth
    pkg = Path(mistra_tpu_torch.__file__).resolve().parent
    check(pkg == ROOT / "mistra_tpu_torch",
          f"mistra_tpu_torch imported from {pkg}, not from {ROOT}")

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.load_library()
    log(f"kernel build + load {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds if build.build_seconds else 0.0:.2f} s)")
    check_ptxas(build.ptxas_log)

    from mistra_tpu_torch.chemistry import lu_cuda
    kernels = timed("phase 2", phase_kernels, growth, bott_cuda)
    sed_shapes = timed("phase 2b", phase_sed)
    with tempfile.TemporaryDirectory(prefix="mistra_inp_") as tmp, \
            tempfile.TemporaryDirectory(prefix="mistra_gas_") as gas_tmp, \
            tempfile.TemporaryDirectory(prefix="mistra_tot_") as ttmp:
        inpdir = input_dir(tmp)
        gasdir, _ = gas_mechanism_dir(gas_tmp)
        counts, main = timed("phase 3", phase_main, inpdir, bott_cuda)
        timed("phase 4", phase_device_vs_cpu, inpdir)
        timed("phase 4b", phase_radiation, inpdir)
        with tempfile.TemporaryDirectory(prefix="mistra_mech_") as mtmp:
            mech, reference = chem_mechanism(mtmp)
        lu_results = timed("phase 5", phase_lu, mech, reference)
        lu_chem_t = timed("phase 5 (chem=T shapes)", phase_lu_chem_t,
                          gasdir)
        counts["batched_inv"], ros3_iterations, main["chemistry"] = \
            timed("phase 6", phase_chem, mech, reference)
        timed("phase 7", phase_chem_device_vs_cpu, mech, reference)
        chem_t_counts, chem_t_iterations, main["chem_t_minute"] = \
            timed("phase 8", phase_chem_t, inpdir, gasdir, bott_cuda,
                  lu_cuda)
        timed("phase 9", phase_chem_t_device_vs_cpu, inpdir, gasdir)
        totdir, _ = tot_mechanism_dir(ttmp)
        mp_counts, mp_iterations, main["multiphase_minute"], mp_in, \
            mp_bott_in = timed("phase 10", phase_multiphase, inpdir, totdir,
                               growth, bott_cuda, lu_cuda)
        check_spills(build.ptxas_log, [(m, dtype) for dtype, m in mp_in])
        lu_mp = timed("phase 10 (the inverse)", phase_lu_multiphase, mp_in)
        bott_mp = timed("phase 10 (Bott)", phase_bott_multiphase, growth,
                        bott_cuda, mp_bott_in)
        del mp_in, mp_bott_in
        main["multiphase_minute"]["card_vs_cpu"] = timed(
            "phase 11", phase_multiphase_device_vs_cpu, inpdir)
        nuc_counts, main["nucleation_column"] = timed(
            "phase 12", phase_nucleation, inpdir, gasdir, bott_cuda, lu_cuda,
            main["chem_t_minute"])
        box_counts, box_main, box_in = timed(
            "phase 13", phase_box, inpdir, totdir, gasdir, bott_cuda,
            lu_cuda)
        main.update(box_minute=box_main["box"],
                    chamber_minute=box_main["chamber"])
        check_spills(build.ptxas_log, [(m, dtype) for dtype, m in box_in])
        lu_box = timed("phase 13 (the inverse)", phase_lu_multiphase, box_in,
                       "box")
        del box_in
        soil_counts, soil_main = timed("phase 14", phase_soil, inpdir,
                                       gasdir, bott_cuda, lu_cuda)
        main.update(soil_mic_f_minute=soil_main["soil mic=F"],
                    soil_minute=soil_main["soil"])
        main["modes_card_vs_cpu"] = timed(
            "phase 15", phase_modes_device_vs_cpu, inpdir)
        main["cli"] = timed("phase 16", phase_cli, inpdir, totdir)
        main["tp_split"] = tp = timed("phase 17", phase_tp, inpdir, gasdir,
                                      totdir, bott_cuda, lu_cuda,
                                      main["multiphase_minute"])
    # each kernel's launches on the modes slice's paths (phases 12-14)
    mode_counts = {"nucleation": nuc_counts, "box": box_counts["box"],
                   "chamber": box_counts["chamber"],
                   "soil_mic_f": soil_counts["soil mic=F"],
                   "soil": soil_counts["soil"]}

    rows = []
    for name, line in (("bott_dwsum", 204), ("bott_advect", 173)):
        rows.append({"name": name, "route": "cuda",
                     "source": "mistra_tpu_torch/csrc/bott.cu",
                     "replaces": f"mistra_tpu/physics/bott_pallas.py:{line}",
                     "launches": counts[name],
                     "launches_per_minute": counts[name] / MAIN_MINUTES,
                     "launches_chem_t": chem_t_counts[name],
                     "launches_per_chem_t_minute":
                         chem_t_counts[name] / CHEM_T_MINUTES,
                     "launches_multiphase": mp_counts[name],
                     "launches_per_multiphase_minute":
                         mp_counts[name] / MP_MINUTES,
                     "main_path_rows_ms": main["main_path_rows"][
                         name.replace("bott_", "") + "_ms"],
                     "multiphase_rows": bott_mp[name],
                     **{f"launches_{p}": c[name]
                        for p, c in mode_counts.items()},
                     "launches_cli": main["cli"]["a"]["launches"][name],
                     "launches_cli_chem": main["cli"]["c"]["launches"][name],
                     # per tp rank: BTZ96 (phase 17 a), chem=T (b),
                     # multiphase (d)
                     "launches_tp": [r["btz96"]["launches"][name]
                                     for r in tp["ranks"]],
                     "launches_tp_chem_t": [r["chem_t"]["launches"][name]
                                            for r in tp["ranks"]],
                     "launches_tp_multiphase": [
                         r["multiphase"]["launches"][name]
                         for r in tp["ranks"]],
                     **kernels[name]})
    # the main path's calls: float64 stage matrices, the aqueous blocks
    # and the Schur complement (one of each per Ros3 step attempt)
    main_calls = [r for (dt, _, kind), r in lu_results.items()
                  if dt == torch.float64 and kind == "stage"]
    inv = {k: sum(r[k] for r in main_calls)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    shape_keys = ("shape", "rel_err", "bit_equal", "residual",
                  "linalg_residual", "ms", "plain_ms", "library_ms",
                  "bound_ms", "bound_by", "roofline_share", "plan",
                  "blocks_per_sm")
    rows.append({
        "name": "batched_inv", "route": "cuda",
        "source": "mistra_tpu_torch/csrc/lu.cu",
        "replaces": "mistra_tpu/chemistry/lu_pallas.py:67,100",
        "launches": counts["batched_inv"],
        "launches_per_ros3_iteration":
            counts["batched_inv"] / ros3_iterations,
        "launches_chem_t": chem_t_counts["batched_inv"],
        "launches_per_chem_t_minute":
            chem_t_counts["batched_inv"] / CHEM_T_MINUTES,
        "chem_t_minute": {
            "launches_per_ros3_iteration":
                chem_t_counts["batched_inv"] / chem_t_iterations,
            # the path's own calls: float32 stage matrices, the bins of
            # m = 4 and the gas core of m = 95, one of each per iteration
            **{k: sum(r[k] for (dt, _, kind), r in lu_chem_t.items()
                      if dt == torch.float32 and kind == "stage")
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "shapes": [{k: r[k] for k in shape_keys}
                       for r in lu_chem_t.values()]},
        "launches_multiphase": mp_counts["batched_inv"],
        "launches_per_multiphase_minute":
            mp_counts["batched_inv"] / MP_MINUTES,
        "multiphase_minute": {
            "launches_per_ros3_iteration":
                mp_counts["batched_inv"] / mp_iterations,
            # the path's own calls, one of each per Ros3 iteration of its
            # solve: the tot solve's float64 aqueous blocks and gas core,
            # the gas-above solve's float32 bins and gas core
            **{k: sum(r[k] for (_, _, kind), r in lu_mp.items()
                      if kind == "stage")
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "shapes": [{k: r[k] for k in shape_keys}
                       for r in lu_mp.values()]},
        **{f"launches_{p}": c["batched_inv"] for p, c in mode_counts.items()},
        "launches_cli": main["cli"]["a"]["launches"]["batched_inv"],
        "launches_cli_chem": main["cli"]["c"]["launches"]["batched_inv"],
        # per tp rank, the chem=T minute of phase 17 (b) and the
        # multiphase minute (d)
        "launches_tp": [r["chem_t"]["launches"]["batched_inv"]
                        for r in tp["ranks"]],
        "launches_tp_multiphase": [r["multiphase"]["launches"]["batched_inv"]
                                   for r in tp["ranks"]],
        "box_minute": {
            "launches_per_ros3_iteration":
                box_counts["box"]["batched_inv"]
                / main["box_minute"]["ros3_iterations"],
            # the box's calls, one of each per Ros3 iteration of its tot
            # solve at the box level: the aqueous blocks and the gas core
            **{k: sum(r[k] for (_, _, kind), r in lu_box.items()
                      if kind == "stage")
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "shapes": [{k: r[k] for k in shape_keys}
                       for r in lu_box.values()]},
        "max_abs_err": max(r["max_abs_err"] for r in main_calls),
        **inv,
        "bound_by": "+".join(sorted({r["bound_by"] for r in main_calls})),
        "roofline_share": inv["bound_ms"] / inv["ms"],
        "shape": " + ".join(r["shape"] for r in main_calls),
        "all": [{k: r[k] for k in shape_keys}
                for r in lu_results.values()]})

    def sed_launches(c):
        """sedp's launches (advsed, once per Courant pass) and sedl's
        (advsed_splits, once per call) in a path's counts."""
        return {"sedp": c["sed_advect"], "sedl": c["sed_splits"]}

    rows.append({
        "name": "sed_advect", "route": "cuda",
        "source": "mistra_tpu_torch/csrc/sed.cu", "replaces": None,
        "launches": sed_launches(counts),
        "launches_per_minute": counts["sed_advect"] / MAIN_MINUTES,
        "launches_chem_t": sed_launches(chem_t_counts),
        "launches_multiphase": sed_launches(mp_counts),
        "launches_per_multiphase_minute": {
            k: v / MP_MINUTES for k, v in sed_launches(mp_counts).items()},
        **{f"launches_{p}": sed_launches(c) for p, c in mode_counts.items()},
        "launches_cli": sed_launches(main["cli"]["a"]["launches"]),
        "launches_cli_chem": sed_launches(main["cli"]["c"]["launches"]),
        # per tp rank: BTZ96 (phase 17 a), chem=T (b), multiphase (d)
        **{f"launches_tp{suffix}": [sed_launches(r[what]["launches"])
                                    for r in tp["ranks"]]
           for suffix, what in (("", "btz96"), ("_chem_t", "chem_t"),
                                ("_multiphase", "multiphase"))},
        "shapes": sed_shapes})
    log(json.dumps({"main_path": main}))
    log(json.dumps({"kernels": rows}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
