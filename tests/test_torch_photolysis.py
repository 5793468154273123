"""Parity of the PyTorch port's photolysis with the JAX package: the table
loader on the synthetic stand-in files (``write_synthetic_photolysis_
tables``, read by both packages), each solver function, the
block-tridiagonal four-stream solve against a dense solve of the same
system, ``compute_jrates`` and the driver for a noon and a midnight column.
Tiny grid, float64; two columns in one batch check the column axis."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, column, foggy, make_models,
                           to_port_columns)

from mistra_tpu.model import solar_zenith
from mistra_tpu.photolysis import jrates as jjrates
from mistra_tpu.photolysis import solver as jsolver
from mistra_tpu.photolysis import tables as jtables
from mistra_tpu_torch.photolysis import jrates as tjrates
from mistra_tpu_torch.photolysis import solver as tsolver
from mistra_tpu_torch.photolysis import tables as ttables

# float64, the same formulas on the same inputs: XLA and torch differ in
# the last bits of exp/log/sqrt and in summation order, and the
# four-stream solve is a refined pivoted block elimination here against
# JAX's dense LU; both amplify rounding by at most the system's condition
# (~1e11 under the noon fog), and each output stays within ~1e-11 of its
# scale (measured 1.4e-11 on the J-rates); a wrong term or index shows at
# 1e-3 or more
TOL = 1e-10
NOON, MIDNIGHT = 0, 1


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    path = tmp_path_factory.mktemp("inp")
    ttables.write_synthetic_photolysis_tables(path)
    return path


@pytest.fixture(scope="module")
def tables(inp):
    phot = str(inp / "photolys") + "/"
    return ttables.load_photolysis_tables(phot), \
        jtables.load_photolysis_tables(phot)


def tt(x):
    return torch.as_tensor(np.asarray(x))


def close_by_column(want_cols, got, tol, what):
    """got [B, ...] against the JAX per-column results want_cols[c]."""
    for c, w in enumerate(want_cols):
        assert_close(w, column(got, c), tol, f"{what}[{c}]")


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------

def test_loader_matches_jax_on_the_stand_in(tables):
    got, want = tables
    for name in ("wave", "dwave", "flux", "cs_ray", "coeff_hno3", "cheb_a",
                 "cheb_b"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert sorted(got.cs) == sorted(want.cs) == sorted(ttables.SINGLE_CS)
    for k in want.cs:
        assert np.array_equal(got.cs[k], want.cs[k]), k
    assert sorted(got.cs_t) == sorted(want.cs_t)
    for k, (arrs, temps) in want.cs_t.items():
        assert np.array_equal(got.cs_t[k][0], arrs), k
        assert np.array_equal(got.cs_t[k][1], temps), k
    # the loader's header test reads the five channels, in both packages
    assert set(got.qy) == set(want.qy) == set(ttables.QY_HEADERS)
    for k in want.qy:
        assert np.array_equal(got.qy[k], want.qy[k]), k


def test_stand_in_is_physically_plausible(tables):
    tb = tables[0]
    nm = tb.wave * 1.0e7
    for k, v in tb.cs.items():
        assert v.shape == (176,) and (v >= 0.0).all() and v.max() > 0.0, k
    for k, (arrs, temps) in tb.cs_t.items():
        assert (arrs > 0.0).all() and np.all(np.diff(temps) > 0.0), k
    # O3 Hartley band ~1.1e-17 cm2 near 255 nm, NO2 ~5.5e-19 near 400 nm
    o3 = tb.cs_t["O3"][0]
    assert 5e-18 < o3.max() < 2e-17 and 245.0 < nm[o3[0].argmax()] < 265.0
    assert 3e-19 < tb.cs_t["NO2"][0].max() < 1e-18
    assert list(tb.cs_t["O3"][1]) == [226.0, 263.0, 298.0]
    # visible flux ~2.5e15 photons cm-2 s-1 per interval, weak in the UV
    assert 1e15 < tb.flux.max() < 5e15 and tb.flux[:13].max() < 1e13
    for k, v in tb.qy.items():
        assert v.shape == (176,) and v.min() >= 0.0 and v.max() <= 1.0, k
    assert tb.qy["NO2"].max() == pytest.approx(1.0)
    # the Schumann-Runge series gives ln(cross section) in -46..-56 over
    # slant O2 columns of e^38..e^56 cm-2
    dl = np.linspace(38.0, 56.0, 7)
    b = np.asarray(jsolver.chebev(38.0, 56.0, tb.cheb_b.T[:, None, :],
                                  dl[None, :]))
    assert -57.0 < b.min() and b.max() < -45.0


# --------------------------------------------------------------------------
# solver functions, on inputs made with numpy from a seed
# --------------------------------------------------------------------------

def profiles(seed=0, B=2, L=12):
    """B columns of top-down level profiles [B, L+1] with a virtual top
    level, and u0 [B] (a high and a low sun)."""
    rng = np.random.default_rng(seed)
    press = np.sort(rng.uniform(0.5, 1013.0, (B, L + 1)), axis=1)
    press[:, 0] = 0.0
    temp = rng.uniform(200.0, 295.0, (B, L + 1))
    o3 = rng.uniform(0.0, 1e-5, (B, L + 1))
    return press, temp, o3, np.array([0.85, 0.05])[:B]


def test_column_densities_match_jax():
    press, temp, o3, u0 = profiles()
    got = tsolver.column_densities(tt(press), tt(temp), tt(o3), tt(u0),
                                   300.0)
    for c in range(len(u0)):
        want = jsolver.column_densities(jnp.asarray(press[c]),
                                        jnp.asarray(temp[c]),
                                        jnp.asarray(o3[c]), u0[c], 300.0)
        for k, w in want.items():
            assert_close(w, column(got[k], c), TOL, k)


def test_chebev_and_sr_o2_match_jax(tables):
    tb = tables[0]
    rng = np.random.default_rng(1)
    x = rng.uniform(30.0, 60.0, (2, 9))
    coeffs = rng.uniform(-1.0, 1.0, (20,))
    got = tsolver.chebev(38.0, 56.0, tt(coeffs), tt(x))
    assert_close(jsolver.chebev(38.0, 56.0, jnp.asarray(coeffs),
                                jnp.asarray(x)), got[None], TOL, "chebev")
    # slant O2 columns below and above e^38 and the cap at e^56
    v2s = np.exp(rng.uniform(36.0, 58.0, (2, 9)))
    temp = rng.uniform(200.0, 295.0, (2, 9))
    got = tsolver.sr_o2_km(tt(tb.cheb_a), tt(tb.cheb_b), tt(v2s), tt(temp))
    want = [jsolver.sr_o2_km(tb, jnp.asarray(v2s[c]), jnp.asarray(temp[c]))
            for c in range(2)]
    close_by_column(want, got, TOL, "sro2")
    assert (got == 0.0).any() and (got > 0.0).any()


@pytest.mark.parametrize("name", ["O3", "NO2", "CH3Cl"])
def test_interp_t_matches_jax(tables, name):
    """Quadratic (O3, CH3Cl: 3 temperatures) and linear (NO2: 2)."""
    tb = tables[0]
    arrs, temps = tb.cs_t[name]
    _, temp, _, _ = profiles(2)
    got = tsolver.interp_t(tt(arrs), tuple(temps), tt(temp))
    want = [jsolver.interp_t(arrs, temps, jnp.asarray(temp[c]))
            for c in range(2)]
    close_by_column(want, got, TOL, name)


def test_qy_o1d_matches_jax(tables):
    tb = tables[0]
    _, temp, _, _ = profiles(3)
    temp[:, :2] = [150.0, 350.0]             # outside the clip range
    base, a, b, hi = tsolver.o1d_tables(tb.wave)
    got = tsolver.qy_o1d(tt(base), tt(a), tt(b), torch.as_tensor(hi),
                         tt(temp))
    want = [jsolver.qy_o1d(tb, jnp.asarray(temp[c])) for c in range(2)]
    close_by_column(want, got, TOL, "qy_o1d")


def optics(seed, kind, B=2, W=6, L=10):
    """Per-layer optical inputs of four_stream: thin, thick, clear (no
    scattering: w = 0, the coefft0 branch) or mixed layers."""
    rng = np.random.default_rng(seed)
    taus = 10.0 ** rng.uniform(-4.0, 0.0, (B, W, L))
    taua = 10.0 ** rng.uniform(-4.0, 0.0, (B, W, L))
    if kind == "thin":
        taus *= 1e-4
        taua *= 1e-4
    elif kind == "thick":
        taus[:, :, ::2] *= 1e3
        taua[:, :, 1::2] = 10.0 ** rng.uniform(1.0, 3.0, (B, W, L // 2))
    elif kind == "clear":
        taus[:] = 0.0
    else:
        taus[:, :, 3] = 0.0
        taua[:, :, 6] = 300.0
        taus[:, 2, :] = 0.0
    g = rng.uniform(0.0, 0.8, (B, W, L))
    ww = [3.0 * g, 5.0 * g ** 2 + 0.1, 7.0 * g ** 3, 9.0 * g ** 4]
    alb = rng.uniform(0.0, 0.3, W)
    flx = 10.0 ** rng.uniform(12.0, 15.0, W)
    return [taus, taua] + ww + [alb, flx, np.array([0.8, 0.12])[:B]]


KINDS = ["thin", "thick", "clear", "mixed"]


@pytest.mark.parametrize("kind", KINDS)
def test_layer_coefficients_match_jax(kind):
    """_coefficients, _coeffl and _coefft0 through the clear/scattering
    selection of four_stream, against the same chain in JAX."""
    taus, taua, w1, w2, w3, w4, alb, flx, u0 = optics(4, kind)
    t0, t, u0s, got = tsolver.layer_coefficients(
        *[tt(x) for x in (taus, taua, w1, w2, w3, w4, flx, u0)])
    for c in range(2):
        tautot = taua[c] + taus[c]
        wc = np.where(tautot < 1e-20, 1.0,
                      taus[c] / np.maximum(tautot, 1e-30))
        f = w4[c] / 9.0
        fw = 1.0 - f * wc
        w = np.clip((1.0 - f) * wc / fw, 0.0, 0.99999999999)
        tt_ = np.cumsum(tautot * fw, axis=1)
        tt0 = np.concatenate([np.zeros((tautot.shape[0], 1)), tt_[:, :-1]],
                             axis=1)
        u = max(u0[c], 1e-6)
        b, a, b1, c1, z = jsolver._coefficients(
            jnp.asarray(w), jnp.asarray((w1[c] - 3.0 * f) / (1.0 - f)),
            jnp.asarray((w2[c] - 5.0 * f) / (1.0 - f)),
            jnp.asarray((w3[c] - 7.0 * f) / (1.0 - f)), u)
        res_s = jsolver._coeffl(jnp.asarray(tt0), jnp.asarray(tt_), u,
                                jnp.asarray(flx[:, None] / np.pi
                                            * np.ones_like(w)),
                                b, a, b1, c1, z)
        res_0 = jsolver._coefft0(jnp.asarray(tt0), jnp.asarray(tt_),
                                 w.shape, jnp.float64)
        clear = w <= 1e-12
        for i, (s, z0, g) in enumerate(zip(res_s, res_0, got)):
            cl = clear.reshape(clear.shape + (1,) * (s.ndim - 2))
            want = np.where(cl, np.asarray(z0), np.asarray(s))
            assert_close(want, column(g, c), TOL, f"coefficient {i}")
        assert_close(tt_, column(t, c), TOL, "t")
    if kind == "clear":
        assert (got[3][..., 0, 3] == 1.0).all()   # the flipped identity


def dense_system(lo, d, up, r):
    """The four-stream system of the blocks as one dense [.., 4L, 4L]
    matrix and right-hand side, row for row as the JAX package assembles
    it (block row j: rows 4j..4j+3)."""
    L = d.shape[-3]
    shape = d.shape[:-3]
    a = torch.zeros(shape + (4 * L, 4 * L), dtype=d.dtype)
    for j in range(L):
        a[..., 4 * j:4 * j + 4, 4 * j:4 * j + 4] = d[..., j, :, :]
        if j > 0:
            a[..., 4 * j:4 * j + 2, 4 * j - 4:4 * j] = lo[..., j - 1, :, :]
        if j < L - 1:
            a[..., 4 * j + 2:4 * j + 4, 4 * j + 4:4 * j + 8] = \
                up[..., j, :, :]
    return a, r.reshape(shape + (4 * L,))


@pytest.mark.parametrize("kind", KINDS)
def test_block_tridiagonal_solve_matches_a_dense_solve(kind):
    """The block Thomas sweep (pivoted 4x4 solves) against LU with partial
    pivoting of the same assembled system, on thin, thick and clear
    layers: within 1e-10 of the solution's scale."""
    args = [tt(x) for x in optics(5, kind)]
    t0, t, u0s, coeffs = tsolver.layer_coefficients(*args[:6], args[7],
                                                    args[8])
    blocks = tsolver.four_stream_blocks(coeffs, t, u0s, args[6], args[7])
    got = tsolver.solve_block_tridiagonal(*blocks)
    a, rhs = dense_system(*blocks)
    want = torch.linalg.solve(a, rhs)
    err = (got.reshape(want.shape) - want).abs().amax() / want.abs().amax()
    print(f"block vs dense solve, {kind} layers: {err:.3e}")
    assert err <= TOL, f"{kind}: {err:.3e}"
    if kind == "thick":
        # the eliminations meet diagonal blocks whose exp(-fk dt) columns
        # underflow to zero
        assert (coeffs[6][..., 2:4, 2:4] == 0.0).any()


@pytest.mark.parametrize("kind", KINDS)
def test_four_stream_matches_jax(kind):
    args = optics(6, kind)
    got = tsolver.four_stream(*[tt(x) for x in args])
    for c in range(2):
        want = jsolver.four_stream(*[jnp.asarray(x[c]) for x in args[:6]],
                                   jnp.asarray(args[6]),
                                   jnp.asarray(args[7]), args[8][c])
        assert_close(want, column(got, c), TOL, f"fact {kind}")
    assert (got >= 0.0).all() and got.amax() > 0.0


# --------------------------------------------------------------------------
# J-rates and the driver, on the radiation driver's profiles
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(inp):
    """(JAX model, port model with its radiation driver installed, JAX
    init state), radiation on, photolysis tables in inp."""
    jm, tm, js = make_models(inp, radiation=True)
    tm.init_state(1)
    return jm, tm, js


@pytest.fixture(scope="module")
def noon_midnight(models):
    """A foggy noon column and the initial midnight column."""
    jm, _, js = models
    tim = js.tim.replace(lst=jnp.int32(12))
    u0 = solar_zenith(tim.lst, tim.lmin, jm.astro.alat, jm.astro.declin)
    noon = foggy(js, jm.cfg.grid.nf, seed=3)
    states = [noon.replace(tim=tim, rad=noon.rad.replace(u0=u0)), js]
    return states, to_port_columns(states)


def slot_close(want, got, tol, what):
    """Each J slot (row) within tol of its largest value."""
    w = np.asarray(want)
    g = got.detach().numpy()
    scale = np.abs(w).max(axis=-1)
    err = np.abs(g - w).max(axis=-1)
    rel = np.where(scale > 0.0, err / np.where(scale > 0.0, scale, 1.0),
                   err)
    print(f"{what}: {rel.max():.3e} of the slot's scale")
    assert rel.max() <= tol, f"{what}: slot {rel.argmax()} {rel.max():.3e}"


def test_compute_jrates_matches_jax(models, noon_midnight):
    """compute_jrates on the driver's top-down inputs of a noon and a
    midnight column, and of the noon column with the sun set (u0 < 0):
    every slot within 1e-10 of its scale; the set sun gives zero."""
    jm, tm, _ = models
    _, ts = noon_midnight
    drv = tm._radiation
    tx, px, _, _, _, bea, baa, ga = drv.load_profile(ts)
    c = drv._consts(tx.device)
    thk = c["thk_td"]
    inputs = dict(press_pa=px.flip(-1), temp=tx.flip(-1),
                  qmo3=c["qmo3_td"].expand(2, -1),
                  taer_s=(bea[:, 0] - baa[:, 0]).flip(-1) * thk,
                  taer_a=baa[:, 0].flip(-1) * thk, ga_pl=ga[:, 0].flip(-1))
    tb = jtables.load_photolysis_tables(str(models[0].cfg.inpdir)
                                        + "/photolys/")
    tabs = tjrates.TableTensors(tb, torch.float64, "cpu")
    for u0 in (ts.rad.u0, torch.tensor([-0.1, 0.2], dtype=torch.float64)):
        got = tjrates.compute_jrates(tabs, u0=u0, albedo=0.05, scaleo3=300.0,
                                     **inputs)
        for col in range(2):
            want = jjrates.compute_jrates(
                tb, u0=float(u0[col]), albedo=0.05, scaleo3=300.0,
                dtype=jnp.float64,
                **{k: jnp.asarray(v[col].numpy()) for k, v in inputs.items()})
            slot_close(want, got[col], TOL, f"J[{col}] u0={float(u0[col])}")
    assert (got[0] == 0.0).all() and got[1].amax() > 0.0


def test_driver_matches_jax_noon_and_midnight(models, noon_midnight):
    """The driver on a noon and a midnight column in one batch, each
    against its own JAX call; the model's rule then zeroes the midnight
    column (u0 below u0min) and keeps the noon one."""
    jm, tm, _ = models
    states, ts = noon_midnight
    jdrv = jax.jit(jjrates.PhotolysisDriver(jm, jm._radiation))
    tdrv = tjrates.PhotolysisDriver(tm, tm._radiation)
    got = tdrv(ts)
    assert got.shape == (2, 47, jm.cfg.grid.n) and got.dtype == torch.float64
    for col, s in enumerate(states):
        slot_close(jdrv(s), got[col], TOL, f"photol_j[{col}]")
    # canonical clear-sky noon magnitudes above the fog, and the fog's
    # shade below it
    assert 3e-3 < float(got[NOON, 0, -1]) < 3e-2       # J_NO2
    assert 1e-4 < float(got[NOON, 46, -1]) < 2e-3     # J_O3P
    assert got[NOON, 0, 1] < 0.1 * got[NOON, 0, -1]
    u0min = 3.48e-2
    assert float(ts.rad.u0[NOON]) > u0min > float(ts.rad.u0[MIDNIGHT])
    kept = torch.where((ts.rad.u0 > u0min)[:, None, None], got, 0.0)
    assert (kept[MIDNIGHT] == 0.0).all() and (kept[NOON] == got[NOON]).all()
