"""Chemistry of the PyTorch port against the JAX package, float64 on the
CPU: the mechanism parser and the synthetic stand-in mechanism, the rate
laws, fun, the Jacobian and its weights, and the Ros3 integrator with the
port's one stage solver, the block-arrow solver, against the JAX
package's dense solver (binned) and sparse solver (unbinned); the solver
itself is in test_torch_block_solver.py.

Inputs are made with numpy from fixed seeds and handed to both packages.
JAX is imported only inside the tests that compare with it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mistra_tpu_torch.chemistry import gas_kernel as tgk
from mistra_tpu_torch.chemistry import mech as tmech
from mistra_tpu_torch.chemistry import rates as trates
from mistra_tpu_torch.chemistry import rosenbrock as tros
from mistra_tpu_torch.chemistry.block_solver import BlockArrowSolver

from _torch_chem import dense_jacobian, environment, jax_env, torch_env

# small stand-in: 16 gas species, bins (1, 2) of 10 aqueous species
N_GAS, N_AQ, BINS = 16, 10, (1, 2)


@pytest.fixture(scope="module")
def jchem():
    """The JAX package's chemistry modules and jax.numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from mistra_tpu.chemistry import gas_kernel, mech, rates, rosenbrock
    return dict(jnp=jnp, gas_kernel=gas_kernel, mech=mech, rates=rates,
                rosenbrock=rosenbrock)


@pytest.fixture(scope="module")
def mechdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mech_small")
    tmech.write_synthetic_multiphase_mechanism(d, N_GAS, N_AQ, seed=0)
    return str(d)


# --------------------------------------------------------------------------
# mechanism
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["small", "default"])
def test_parsed_mechanism_matches_jax(jchem, tmp_path, size):
    if size == "small":
        tmech.write_synthetic_multiphase_mechanism(tmp_path, N_GAS, N_AQ)
        bins = BINS
    else:
        tmech.write_synthetic_multiphase_mechanism(tmp_path)
        bins = (1, 2, 3, 4)
    mj = jchem["mech"].load_multiphase_mechanism(str(tmp_path), bins=bins,
                                                 name="tot")
    mt = tmech.load_multiphase_mechanism(str(tmp_path), bins=bins,
                                         name="tot")
    assert mt.species == mj.species
    assert mt.fixed == mj.fixed
    assert np.array_equal(mt.stoich, mj.stoich)
    assert np.array_equal(mt.ridx, mj.ridx)
    assert np.array_equal(mt.species_bin, mj.species_bin)
    assert [r.rate_expr for r in mt.reactions] == \
        [r.rate_expr for r in mj.reactions]


def test_default_stand_in_has_the_tot_block_shape(tmp_path):
    tmech.write_synthetic_multiphase_mechanism(tmp_path)
    mech = tmech.load_multiphase_mechanism(str(tmp_path), name="tot")
    assert mech.nvar == 421
    assert 1550 <= mech.nrxn <= 1700
    assert np.array_equal(np.bincount(mech.species_bin), [101, 80, 80, 80,
                                                          80])
    # block-arrow: no reaction couples two bins (the solver raises if one
    # does), and the kernel builds it
    solver = BlockArrowSolver(mech, dtype=torch.float64, device="cpu")
    assert (solver.nbin, solver.ma, solver.mg) == (4, 80, 101)
    block = tgk.GasKernel(mech, device="cpu").block
    assert (block.nbin, block.ma, block.mg) == (4, 80, 101)
    # only constants, farr and farr2; the text says what it is
    for rx in mech.reactions:
        assert rx.rate_expr.split("(")[0] in ("farr", "farr2") or \
            float(rx.rate_expr) > 0.0
    with open(tmp_path / "master_gas.eqn") as f:
        assert "not the reference" in f.read()


def test_stand_in_depends_on_seed_only(tmp_path):
    a, b, c = (tmp_path / n for n in "abc")
    for d, seed in ((a, 3), (b, 3), (c, 4)):
        d.mkdir()
        tmech.write_synthetic_multiphase_mechanism(d, N_GAS, N_AQ, seed)
    text = [open(d / "master_aqueous.eqn").read() for d in (a, b, c)]
    assert text[0] == text[1] != text[2]


# --------------------------------------------------------------------------
# rate laws
# --------------------------------------------------------------------------

# one reaction per rate law of make_namespace; Python-float and tensor
# arguments both, and the zero branches of fbck2/fbck2b/flsc*/up*
RATE_LAWS = """
{L01} A = B : farr(1.0e-12, -500.0) ;
{L02} A = B : farr2(3.0e5, 1200.0) ;
{L03} A = B : farr_sp(2.0e-12, 300.0, -1.5, 250.0) ;
{L04} A = B : atk_3(3.3e-31, -4.3, 1.6e-12, 0.0, 0.6) ;
{L05} A = B : atk_3a(2.5e-30, -4.4, 1.6e-11, -1.7, 430.0) ;
{L06} A = B : atk_3c(1.3e-3, 9.7e14, 0.0) ;
{L07} A = B : atk_3c(1.3e-3, 9.7e14, 0.4) ;
{L08} A = B : atk_3d(2.2e-3, 9.7e14, 0.3) ;
{L09} A = B : atk_3e(2.0e-30, -4.4, 1.4e-11, -0.7, 0.6) ;
{L10} A = B : atk_3f(1.0e-31, -1.6, 3.0e-11, 0.3, 0.6) ;
{L11} A = B : shno3(2.4e-14, 460.0, 2.7e-17, 2199.0, 6.5e-34, 1335.0) ;
{L12} A = B : fbck(1.8e-31, -3.2, 4.7e-12, -1.4, 0.6, 2.1e-27, 10900.0) ;
{L13} A = B : fbckj(1.8e-31, -3.2, 4.7e-12, -1.4, 2.1e-27, 10900.0) ;
{L14} A = B : fbck2(5.2e-31, -3.2, 6.9e-12, -2.9, 0.6, 1.0e-3) ;
{L15} A = B : fbck2(5.2e-31, -3.2, 6.9e-12, -2.9, 0.6, 0.0) ;
{L16} A = B : fbck2b(5.2e-31, -3.2, 6.9e-12, -2.9, 5.4e-9, 14192.0, 2.0e-3) ;
{L17} A = B : fbck2b(5.2e-31, -3.2, 6.9e-12, -2.9, 5.4e-9, 14192.0, 0.0) ;
{L18} A = B : sp_17(1.5e-13, 4.2e19) ;
{L19} A = B : sp_23(2.3e-13, 600.0, 1.7e-33, 1000.0, 1.4e-21, 2200.0) ;
{L20} A = B : sp_29(1.0e-31, -1.6, 3.0e-11, 0.3, 0.6) ;
{L21} A = B : fcn(2.0e-5) ;
{L22} A = B : dms_add() ;
{L23} A = B : het_uptake(0.1, 63.0) ;
{L24} A = B : surf_uptake(0.02, 46.0) ;
{L25} A = B : dmin2(farr(1.0e8, 1000.0)) ;
{L26} A = B : dmin3(farr(1.0e-3, 100.0)) ;
{L27} A = B : flsc(1.0e3, 2.0, te * 1.0e-3, 0.5) ;
{L28} A = B : flsc(1.0e3, 2.0, 0.0, 0.5) ;
{L29} A = B : flsc4(3.0, 2.0, te * 1.0e-3) ;
{L30} A = B : flsc5(3.0, 2.0, 0.0) ;
{L31} A = B : flsc5(3.0, 2.0, 0.3) ;
{L32} A = B : flsc6(3.0, te * 1.0e-17) ;
{L33} A = B : flsc6(3.0, 1.0e-20) ;
{L34} A = B : fliq_60(1.0e4, 300.0, 0.1, te * 1.0e-2) ;
{L35} A = B : fliq_60(1.0e4, 300.0, 0.1, 0.0) ;
{L36} A = B : uplim(1.0e4, 1.0e10, te * 1.0e-3, 1.0e-3) ;
{L37} A = B : uplim(1.0e4, 1.0e10, -1.0, 0.0) ;
{L38} A = B : uparm(1.0e5, 1500.0, 1.0e10, te * 1.0e-6, 2.0) ;
{L39} A = B : uplip(1.0e9, te * 1.0e-3, 1.0e-2) ;
{L40} A = B : uplip(1.0e9, 1.0, 0.0) ;
{L41} A = B : uparp(1.0e9, 300.0, 1.0e-3, te * 1.0e-4) ;
{L42} A + B = C : 1.0e-11 * conv1 * xhal * xiod ;
{L43} A = B : ph_rat(3) ;
{L44} A + O2 = C : 1.0d-15 * fix(indf_o2) / aircc + h2oppm * pk * 1.0d-12 ;
"""


def test_rate_constants_match_jax(jchem):
    mj = jchem["mech"].parse_eqn(RATE_LAWS, name="laws")
    mt = tmech.parse_eqn(RATE_LAWS, name="laws")
    env, fix = environment(6, 11, mt.fixed)
    kj = np.asarray(jchem["gas_kernel"].GasKernel(mj).rate_constants(
        jax_env(env, xhal=0.7, xiod=0.3),
        fix=jchem["jnp"].asarray(fix)))
    kt = tgk.GasKernel(mt, device="cpu").rate_constants(
        torch_env(env, xhal=0.7, xiod=0.3), fix=torch.tensor(fix))
    assert kt.dtype == torch.float64 and kt.shape == (6, mt.nrxn)
    kt = kt.numpy()
    assert np.all(np.isfinite(kt))
    # the zero branches are zero in both
    zero = [i for i, rx in enumerate(mt.reactions)
            if rx.label in ("L15", "L17", "L28", "L30", "L33", "L35", "L37",
                            "L40")]
    assert np.all(kt[:, zero] == 0.0) and np.all(kj[:, zero] == 0.0)
    rel = np.abs(kt - kj) / np.maximum(np.abs(kj), 1e-300)
    assert rel.max() <= 1e-13, [mt.reactions[i].label
                                for i in np.argmax(rel, axis=1)]


def test_probe_dry_extras_matches_jax(jchem):
    text = ("{H1} A = B : xliq1 * farr(1.0e-3, 100.0) ;\n"
            "{H2} B = C : yxkmt(ind_b, 1) + 2.0 ;\n"
            "{H3} C = A : fdhet_a(1, 2) + xhet1 ;\n")
    mj = jchem["mech"].parse_eqn(text)
    mt = tmech.parse_eqn(text)
    env, _ = environment(3, 5, ())
    zj = jchem["jnp"].zeros(3)
    ej = jchem["rates"].probe_dry_extras(mj, jax_env(env), zj)
    et = trates.probe_dry_extras(mt, torch_env(env),
                                 torch.zeros(3, dtype=torch.float64))
    assert set(et) == set(ej) == {"xliq1", "yxkmt", "ind_b", "fdhet_a",
                                  "xhet1"}
    kt = tgk.GasKernel(mt, device="cpu").rate_constants(torch_env(env, extras=et))
    assert np.array_equal(kt.numpy(), np.tile([0.0, 2.0, 0.0], (3, 1)))


# --------------------------------------------------------------------------
# fun, Jacobian and its weights
# --------------------------------------------------------------------------

def random_state(mech, B, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((B, mech.nvar)) * 1e-8,
            rng.random((B, mech.nrxn)) * 1e-3 * 10.0 ** rng.uniform(
                -2, 8, mech.nrxn),
            rng.random((B, len(mech.fixed))) * 10)


@pytest.fixture(scope="module")
def small_pair(jchem, mechdir):
    mj = jchem["mech"].load_multiphase_mechanism(mechdir, bins=BINS)
    mt = tmech.load_multiphase_mechanism(mechdir, bins=BINS)
    return mj, mt


def test_fun_jac_weights_match_jax(jchem, small_pair):
    jnp = jchem["jnp"]
    mj, mt = small_pair
    y, k, fix = random_state(mt, 5, 2)
    kj = jchem["gas_kernel"].GasKernel(mj, dtype=jnp.float64,
                                       solver="dense")
    kt = tgk.GasKernel(mt, dtype=torch.float64, device="cpu")
    ja = [jnp.asarray(a) for a in (y, k, fix)]
    ta = [torch.tensor(a) for a in (y, k, fix)]
    # fun: relative to the sum of the magnitudes of its terms
    r = np.asarray(kj.reaction_rates(*ja))
    scale = np.abs(r) @ np.abs(mt.stoich)
    assert np.array_equal(kt.reaction_rates(*ta).numpy(), r)
    assert (np.abs(kt.fun(*ta).numpy() - np.asarray(kj.fun(*ja)))
            <= 1e-12 * scale).all()
    # jac, kw_weights: relative to their largest entry per cell
    kw = kt.kw_weights(*ta)
    for name, got in (("jac", dense_jacobian(mt, kw)), ("kw_weights", kw)):
        want = np.asarray(getattr(kj, name)(*ja))
        amax = np.abs(want).reshape(5, -1).max(axis=1)
        err = np.abs(got.numpy() - want).reshape(5, -1).max(axis=1)
        assert (err <= 1e-12 * amax).all(), name


# --------------------------------------------------------------------------
# Ros3
# --------------------------------------------------------------------------

def integrate_both(jchem, mj, mt, jax_solver, B=4, seed=1, dt=10.0):
    """Integrate the same cells with both packages, the JAX package with
    its ``jax_solver`` and the port with its block-arrow solver; returns
    y and nsteps of each."""
    jnp = jchem["jnp"]
    env, fix = environment(B, seed, mt.fixed)
    y0 = 1e-8 * np.random.default_rng(seed + 1).lognormal(0.0, 1.0,
                                                           (B, mt.nvar))
    kj = jchem["gas_kernel"].GasKernel(mj, dtype=jnp.float64,
                                       solver=jax_solver)
    kkj = kj.rate_constants(jax_env(env), fix=jnp.asarray(fix))
    yj, ij = kj.integrate(jnp.asarray(y0), kkj, jnp.asarray(fix), dt)
    kt = tgk.GasKernel(mt, dtype=torch.float64, device="cpu")
    kkt = kt.rate_constants(torch_env(env), fix=torch.tensor(fix))
    yt, it = kt.integrate(torch.tensor(y0), kkt, torch.tensor(fix), dt)
    assert set(it) == set(ij)
    assert int(it["n_failed"]) == int(ij["n_failed"]) == 0
    assert bool(it["done"].all())
    return (np.asarray(yj), np.asarray(ij["nsteps"]), yt.numpy(),
            it["nsteps"].numpy())


def test_integrate_dense_matches_jax(jchem, small_pair):
    """The binned stand-in: the port's block solver against the JAX
    package's dense LU."""
    mj, mt = small_pair
    yj, nj, yt, nt = integrate_both(jchem, mj, mt, "dense")
    np.testing.assert_allclose(yt, yj, rtol=1e-8, atol=1e-22)
    assert np.array_equal(nt, nj)
    assert nt.min() >= 30


def test_integrate_unbinned_block_matches_jax_sparse(jchem, mechdir):
    """An unbinned mechanism (master_gas.eqn alone): the port's block
    solver, all gas core, against the JAX package's sparse LU."""
    mj = jchem["mech"].load_gas_mechanism(mechdir)
    mt = tmech.load_gas_mechanism(mechdir)
    assert tgk.GasKernel(mt, device="cpu").block.nbin == 0
    yj, nj, yt, nt = integrate_both(jchem, mj, mt, "sparse", B=3, seed=4,
                                    dt=5.0)
    np.testing.assert_allclose(yt, yj, rtol=1e-8, atol=1e-22)
    assert np.array_equal(nt, nj)


def test_ros_options_for_dtype():
    opts = tros.RosOptions()
    assert opts.for_dtype(torch.float64) is opts
    assert opts.for_dtype(torch.float32).atol == 1e-16


def test_per_cell_failure_masking():
    """One pathologically stiff cell must not stall the others (reference
    warns per cell and continues, gas.f:764-767)."""
    lam = torch.tensor([float("nan"), 1.0, 2.0], dtype=torch.float64)

    def fun(y):
        # cell 0's NaN tendency forces an endless rejection loop (the NaN
        # guard treats it as a failed step)
        return -lam[:, None] * y

    eye = torch.eye(1, dtype=torch.float64)

    class Lin:
        def jac(self, y):
            return -torch.where(torch.isfinite(lam), lam,
                                1.0)[:, None, None] * eye[None]

        def prepare(self, j, ghinv):
            return ghinv[:, None, None] * eye[None] - j

        def solve(self, fact, rhs):
            return rhs / fact[:, :, 0]

    y0 = torch.ones((3, 1), dtype=torch.float64)
    opts = tros.RosOptions(max_steps=200)
    y, info = tros.integrate(fun, Lin(), y0, 10.0, opts)
    failed = info["failed"].numpy()
    done_t = info["t"].numpy()
    # the two well-behaved cells reach tend even though cell 0 fails
    assert done_t[1] >= 10.0 * (1 - 1e-9)
    assert done_t[2] >= 10.0 * (1 - 1e-9)
    assert not failed[1] and not failed[2]
    assert failed[0] and done_t[0] < 10.0
    assert int(info["n_failed"]) == 1
    assert info["nsteps"][0].item() == 200
    # local error control at rtol=1e-3 over 10-20 e-folds: a few percent
    np.testing.assert_allclose(y[1:, 0].numpy(), np.exp([-10.0, -20.0]),
                               rtol=5e-2)


def test_load_species_csv(jchem, tmp_path):
    path = tmp_path / "gas_species.csv"
    path.write_text("! index name mass ground top emission\n"
                    "1 O3 48.0E-3 30.0 40.0 0.0\n"
                    "2 NO2 46.0E-3 0.1 0.01 1.0e9\n"
                    "3 bad row\n"
                    "x SO2 64.0E-3 0.2 0.1 0.0\n")
    got = tgk.load_species_csv(str(path))
    assert got == jchem["gas_kernel"].load_species_csv(str(path))
    assert [s["name"] for s in got] == ["O3", "NO2"]
    assert got[1]["mass"] == 46.0e-3 and got[1]["emission"] == 1.0e9
