"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: requires CUDA, prints the card and its power limit, builds the
     CUDA kernels of mistra_tpu_torch/csrc with nvcc;
  2. kernels against their plain torch versions on the card, at the
     production shape (100 levels x 70 dry bins rows of 70 bins per
     column), float64 and float32, walk band J in {32, 70}; times both;
  3. main path: the BTZ96 minute step (mic=T, chem=F, radiation off) at
     the production grid in float32 for 64 columns, three minutes, with
     the kernels' launch counters read around it;
  4. the same port on the card (kernels) against the port on the CPU
     (plain versions): one column, float64, one minute.

The last two lines are a JSON object of per-kernel results and the
device line {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

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

# kernel against plain, on one card, same inputs.  The kernels do the plain
# version's arithmetic expression by expression (no contracted multiply-
# adds); what differs is the order of the row reductions.  The error is
# taken relative to the row's largest bin (advect) or, for dwsum, a
# difference of gained and lost water mass, to the sum of the magnitudes
# it is made of, sum_k (|psi_k| + |z_k|) e_k.
KERNEL_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
# advect conserves each row's mass of significant bins
MASS_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
# card against CPU, one column, float64, one minute: relative to each
# field's largest magnitude.  Libm and reduction order differ between the
# devices; a flip of one Newton convergence test (|res| < 1e-6) moves the
# mean saturation by ~1e-6, which bounds what t, xm1 and ff can move by.
DEVICE_TOL = {"t": 1e-6, "xm1": 1e-6, "ff": 1e-5}


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


def dwsum_scale(psi, z, e):
    """Per-row magnitude of the terms of dwsum: sum_k (|psi_k|+|z_k|) e_k."""
    return ((psi.abs() + z.abs()) * e).sum(dim=1).clamp(min=1e-300)


def compare_kernels(growth, bott_cuda, rows, dtype, J, seed, plain_reps):
    """Both kernels against their plain versions on one input of rows x 70
    bins: checks agreement and advect's mass, times both (CUDA events)
    and returns each kernel's result fields."""
    nkt = 70
    u, z, e = bott_inputs(rows, nkt, dtype, seed)
    zmax = z.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)

    psi_k = bott_cuda.bott_advect(DT, u, z, J)
    psi_p = growth.bott_advect_plain(DT, u, z, J)
    rel_a = ((psi_k - psi_p).abs() / zmax).max().item()
    sig = torch.where(z >= growth.YMIN, z, 0.0).sum(dim=1)
    mass = ((psi_k.sum(dim=1) - sig).abs()
            / sig.clamp(min=1e-300)).max().item()
    dw_k = bott_cuda.bott_dwsum(DT, u, z, e, J)
    dw_p = growth.bott_dwsum_plain(DT, u, z, e, J)
    rel_d = ((dw_k - dw_p).abs() / dwsum_scale(psi_p, z, e)).max().item()

    tol = KERNEL_TOL[dtype]
    shape = f"{rows}x{nkt} {str(dtype).replace('torch.', '')} J={J}"
    out = {
        "bott_advect": dict(
            max_abs_err=(psi_k - psi_p).abs().max().item(), rel_err=rel_a,
            tol=tol, shape=shape,
            ms=cuda_ms(lambda: bott_cuda.bott_advect(DT, u, z, J), 20),
            plain_ms=cuda_ms(lambda: growth.bott_advect_plain(DT, u, z, J),
                             plain_reps)),
        "bott_dwsum": dict(
            max_abs_err=(dw_k - dw_p).abs().max().item(), rel_err=rel_d,
            tol=tol, shape=shape,
            ms=cuda_ms(lambda: bott_cuda.bott_dwsum(DT, u, z, e, J), 20),
            plain_ms=cuda_ms(
                lambda: growth.bott_dwsum_plain(DT, u, z, e, J),
                plain_reps)),
    }
    log(f"kernels {shape}: " + "; ".join(
        f"{k} err {r['max_abs_err']:.3e} (rel {r['rel_err']:.3e}) "
        f"{r['ms'] * 1e3:.1f} us vs plain {r['plain_ms'] * 1e3:.1f} us"
        for k, r in out.items()) + f"; advect mass {mass:.3e}")
    check(rel_a <= tol, f"advect disagrees: {rel_a} > {tol}")
    check(rel_d <= tol, f"dwsum disagrees: {rel_d} > {tol}")
    check(mass <= MASS_TOL[dtype], f"advect mass error {mass}")
    return out


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


def clarke_dir(tmp: str) -> str:
    """INPDIR if it holds clarke.dat, else tmp with the synthetic table."""
    inpdir = os.environ.get("INPDIR")
    if inpdir and os.path.exists(os.path.join(inpdir, "clarke.dat")):
        log(f"clarke.dat: reference table from INPDIR ({inpdir})")
        return inpdir
    from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
    write_synthetic_clarke_table(tmp)
    log("clarke.dat: synthetic stand-in (INPDIR has none)")
    return tmp


def phase_main(inpdir, bott_cuda):
    """The BTZ96 minute step on the card; returns the launch counts."""
    from mistra_tpu_torch import MistraConfig, Model
    cfg = MistraConfig(dtype="float32", inpdir=inpdir, **BTZ96)
    model = Model(cfg, device="cuda")
    state = model.init_state(MAIN_COLUMNS)
    torch.cuda.synchronize()
    t_start = state.tim.time.clone()

    bott_cuda.reset_counts()
    times = []
    for _ in range(MAIN_MINUTES):
        t0 = time.perf_counter()
        state = model.minute_step(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = {"bott_dwsum": bott_cuda.bott_dwsum.launches,
              "bott_advect": bott_cuda.bott_advect.launches}

    gp = cfg.grid
    for sub in ("met", "turb", "surf", "micro"):
        for name, x in vars(getattr(state, sub)).items():
            if x.is_floating_point():
                check(bool(torch.isfinite(x).all()),
                      f"non-finite {sub}.{name}")
    shape = tuple(state.micro.ff.shape)
    check(shape == (MAIN_COLUMNS, gp.nkt, gp.nka, gp.n), f"ff shape {shape}")
    advanced = (state.tim.time - t_start).cpu().numpy()
    check(np.all(advanced == 60.0 * MAIN_MINUTES), f"clock {advanced}")
    check(bool((state.tim.lmin == MAIN_MINUTES).all()), "minute counter")
    # every substep runs at least one Newton iteration and one replay
    check(counts["bott_dwsum"] >= 6 * MAIN_MINUTES, f"launches {counts}")
    check(counts["bott_advect"] == 6 * MAIN_MINUTES, f"launches {counts}")

    steady = times[1:] if len(times) > 1 else times
    ms = 1e3 * sum(steady) / len(steady)
    log(f"main path: {MAIN_COLUMNS} columns x {MAIN_MINUTES} minutes, "
        f"float32, production grid; minute step "
        f"{[round(1e3 * t, 1) for t in times]} ms, steady {ms:.1f} ms = "
        f"{MAIN_COLUMNS / (ms / 1e3):.2f} column-minutes/s; launches "
        f"{counts}; max xm2 {state.met.xm2.max().item():.3e} kg/m3")
    return counts


def phase_device_vs_cpu(inpdir):
    """Port on the card (kernels) against the port on the CPU (plain)."""
    from mistra_tpu_torch import MistraConfig, Model
    cfg = MistraConfig(dtype="float64", inpdir=inpdir, **BTZ96)
    out = {}
    for dev in ("cuda", "cpu"):
        model = Model(cfg, device=dev)
        state = model.minute_step(model.init_state(1))
        out[dev] = {k: v.cpu().numpy() for k, v in (
            ("t", state.met.t), ("xm1", state.met.xm1),
            ("ff", state.micro.ff))}
    errs = {}
    for k, tol in DEVICE_TOL.items():
        ref = out["cpu"][k]
        errs[k] = float(np.abs(out["cuda"][k] - ref).max()
                        / np.abs(ref).max())
        check(errs[k] <= tol, f"{k}: card vs CPU {errs[k]:.3e} > {tol}")
    log("card vs cpu (1 column, float64, 1 minute) max rel err: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))


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
    for line in build.ptxas_log.splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas: " + line.strip())

    kernels = phase_kernels(growth, bott_cuda)
    with tempfile.TemporaryDirectory(prefix="mistra_inp_") as tmp:
        inpdir = clarke_dir(tmp)
        counts = phase_main(inpdir, bott_cuda)
        phase_device_vs_cpu(inpdir)

    rows = []
    for name, line in (("bott_dwsum", 204), ("bott_advect", 173)):
        rows.append({"name": name, "route": "cuda",
                     "source": "mistra_tpu_torch/csrc/bott.cu",
                     "replaces": f"mistra_tpu/physics/bott_pallas.py:{line}",
                     "launches": counts[name], **kernels[name]})
    log(json.dumps({"kernels": rows}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
