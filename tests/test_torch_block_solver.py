"""Block-arrow stage solver and batched inverse of the PyTorch port.

On the CPU, in float64 unless stated: ``assemble``/``prepare``/``solve``
and the whole Ros3 integration with the block solver against the JAX
package on a small synthetic stand-in mechanism; ``batched_inv_plain``
against the JAX package's inverses; the router.  On a CUDA device: the
hand-written kernel (csrc/lu.cu) against the plain version, bit for bit,
and its launch plan (which the CPU tests check in Python).

The CUDA tests run on a GPU host without JAX and without the suite's
conftest (which configures JAX):
    python -m pytest --noconftest -m gpu tests/test_torch_block_solver.py
so this file imports JAX only inside the tests that compare with it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mistra_tpu_torch.chemistry import gas_kernel as tgk
from mistra_tpu_torch.chemistry import lu, lu_cuda
from mistra_tpu_torch.chemistry import mech as tmech

from _torch_chem import environment, jax_env, torch_env

N_GAS, N_AQ, BINS = 16, 10, (1, 2)
# kernel against plain on the card: the same operations in the same order
# (no contracted multiply-adds), so equal up to a differing rounding of
# the compilers; relative to the largest entry of the inverse
KERNEL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture(scope="module")
def kernels(jnp, tmp_path_factory):
    """(JAX GasKernel, port GasKernel, mechanism) of the small stand-in,
    block solver, float64."""
    from mistra_tpu.chemistry.gas_kernel import GasKernel
    from mistra_tpu.chemistry.mech import load_multiphase_mechanism
    d = str(tmp_path_factory.mktemp("mech_block"))
    tmech.write_synthetic_multiphase_mechanism(d, N_GAS, N_AQ, seed=0)
    mt = tmech.load_multiphase_mechanism(d, bins=BINS)
    kj = GasKernel(load_multiphase_mechanism(d, bins=BINS),
                   dtype=jnp.float64)
    kt = tgk.GasKernel(mt, dtype=torch.float64, device="cpu")
    assert kj.solver == kt.solver == "block"
    return kj, kt, mt


def block_state(mech, B, seed):
    """Concentrations, rate constants over ten decades, fixed species and
    the stage factor ghinv over the range Ros3 steps take."""
    rng = np.random.default_rng(seed)
    return (rng.random((B, mech.nvar)) * 1e-8,
            rng.random((B, mech.nrxn)) * 10.0 ** rng.uniform(
                -4, 6, (B, mech.nrxn)),
            rng.random((B, len(mech.fixed))) * 10,
            10.0 ** rng.uniform(-1, 4, B))


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def test_assemble_matches_jax_and_a_numpy_sum(jnp, kernels):
    kj, kt, mt = kernels
    y, k, fix, _ = block_state(mt, 3, 1)
    kw = kt.kw_weights(*(torch.tensor(a) for a in (y, k, fix)))
    got = kt.block.assemble(kw)
    want = kj.block.assemble(jnp.asarray(kw.numpy()))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_err(g.numpy(), w) <= 1e-14
    # the rounds of the segment sum add every term exactly once
    b = kt.block
    vals = (b._term_coeff[None] * kw[:, b._term_lr]).numpy()
    flat = np.zeros((3, b.flat_size))
    for i, t in enumerate(b._term_tgt.numpy()):
        flat[:, t] += vals[:, i]
    assert rel_err(torch.cat([g.reshape(3, -1) for g in got], 1).numpy(),
                   flat) <= 1e-15


def test_prepare_matches_jax(jnp, kernels):
    kj, kt, mt = kernels
    y, k, fix, ghinv = block_state(mt, 4, 2)
    kw = kt.kw_weights(*(torch.tensor(a) for a in (y, k, fix)))
    fj = kj.block.prepare(kj.block.assemble(jnp.asarray(kw.numpy())),
                          jnp.asarray(ghinv))
    ft = kt.block.prepare(kt.block.assemble(kw), torch.tensor(ghinv))
    for name, j in zip(("inv_a", "gmat", "hmat", "inv_s", "r_aq", "r_g"),
                       fj[:6]):
        got = getattr(ft, name).numpy()
        assert got.shape == j.shape
        assert rel_err(got, j) <= 1e-10, name
    # the row scales are powers of two
    for r in (ft.r_aq, ft.r_g):
        m, _ = torch.frexp(r)
        assert bool((m == 0.5).all())


def test_block_solve_residual(kernels):
    """(ghinv I - J) x = b solved by the block factorization; the residual
    is checked with the dense Jacobian."""
    _, kt, mt = kernels
    y, k, fix, _ = block_state(mt, 3, 3)
    y, k, fix = (torch.tensor(a) for a in (y, k, fix))
    ghinv = torch.full((3,), 7.3, dtype=torch.float64)
    rhs = torch.tensor(np.random.default_rng(4).random((3, mt.nvar)))
    fact = kt.block.prepare(kt.block.assemble(kt.kw_weights(y, k, fix)),
                            ghinv)
    x = kt.block.solve(fact, rhs)
    jx = torch.einsum("bij,bj->bi", kt.jac(y, k, fix), x)
    r = ghinv[:, None] * x - jx - rhs
    assert r.abs().max().item() < 1e-10


def test_integrate_block_matches_jax(jnp, kernels):
    kj, kt, mt = kernels
    B = 4
    env, fix = environment(B, 1, mt.fixed)
    y0 = 1e-8 * np.random.default_rng(2).lognormal(0.0, 1.0, (B, mt.nvar))
    kkj = kj.rate_constants(jax_env(env), fix=jnp.asarray(fix))
    yj, ij = kj.integrate(jnp.asarray(y0), kkj, jnp.asarray(fix), 10.0)
    kkt = kt.rate_constants(torch_env(env), fix=torch.tensor(fix))
    lu_cuda.reset_counts()
    yt, it = kt.integrate(torch.tensor(y0), kkt, torch.tensor(fix), 10.0)
    assert lu_cuda.batched_inv.launches == 0
    assert int(it["n_failed"]) == int(ij["n_failed"]) == 0
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-8,
                               atol=1e-22)
    assert np.array_equal(it["nsteps"].numpy(), np.asarray(ij["nsteps"]))
    assert it["nsteps"].min().item() >= 30


# --------------------------------------------------------------------------
# batched inverse
# --------------------------------------------------------------------------

def dominant(n, m, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.random((n, m, m)) + 4.0 * np.eye(m)).astype(dtype)


def needs_pivoting(n, m, seed):
    """Random matrices whose leading diagonal entries are zero (a no-pivot
    elimination divides by zero at step 0)."""
    a = np.random.default_rng(seed).standard_normal((n, m, m))
    a[:, np.arange(m // 2), np.arange(m // 2)] = 0.0
    return a


def test_plain_inverse_against_jax_pallas_f32(jnp):
    from mistra_tpu.chemistry.lu_pallas import batched_inv_nopivot
    a = dominant(130, 23, 2, np.float32)
    want = np.asarray(batched_inv_nopivot(jnp.asarray(a), use_pallas=True,
                                          interpret=True))
    got = lu.batched_inv_plain(torch.tensor(a))
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("kind", ["dominant", "pivoting"])
def test_plain_inverse_against_jax_f64(jnp, kind):
    a = dominant(40, 31, 3) if kind == "dominant" else needs_pivoting(
        40, 31, 3)
    want = np.asarray(jnp.linalg.inv(jnp.asarray(a)))
    got = lu.batched_inv_plain(torch.tensor(a)).numpy()
    assert rel_err(got, want) <= 1e-12
    assert np.abs(np.einsum("nij,njk->nik", a, got)
                  - np.eye(31)).max() <= 1e-12


def test_plain_inverse_pivot_rule():
    # a zero leading entry and a tie |-2| = |2| in column 0 (the first of
    # rows 1, 2 is taken); a singular matrix gives non-finite output
    # rather than an error
    a = torch.tensor([[[0.0, 1.0, 0.0], [-2.0, 0.0, 1.0], [2.0, 1.0, 1.0]],
                      [[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [0.0, 0.0, 1.0]]],
                     dtype=torch.float64)
    x = lu.batched_inv_plain(a)
    np.testing.assert_allclose(x[0].numpy(), np.linalg.inv(a[0].numpy()),
                               rtol=1e-15, atol=1e-15)
    assert not bool(torch.isfinite(x[1]).all())


def test_router_takes_plain_on_cpu_and_refuses_other_devices():
    a = torch.tensor(dominant(5, 7, 4))
    lu_cuda.reset_counts()
    assert torch.equal(lu.batched_inv(a), lu.batched_inv_plain(a))
    assert lu_cuda.batched_inv.launches == 0
    with pytest.raises(ValueError):
        lu_cuda.batched_inv(a)
    with pytest.raises(ValueError):
        lu.batched_inv(a.to("meta"))


def test_kernel_shared_memory_bound():
    # the largest matrices the shared-memory variant holds in 227 KB; the
    # register variant stays within the default 48 KB up to m = 128
    f64, f32 = torch.float64, torch.float32
    assert lu_cuda.launch_plan(168, f64).smem_bytes <= 232448
    assert lu_cuda.launch_plan(238, f32).smem_bytes <= 232448
    for m, dtype in ((169, f64), (239, f32)):
        with pytest.raises(ValueError):
            lu_cuda.launch_plan(m, dtype)
    assert max(lu_cuda.launch_plan(m, f64).smem_bytes
               for m in range(1, 129)) <= 48 * 1024


# m -> (variant, thread grid ty lanes x tx warps, tile ry x rx): the
# register tiles' edges, the tot mechanism's blocks, the variant switch at
# 128 and the largest shared-memory sizes
PLANS = {1: ("regs", 32, 8, 1, 4), 15: ("regs", 32, 8, 1, 4),
         16: ("regs", 32, 8, 1, 4), 17: ("regs", 32, 8, 1, 4),
         32: ("regs", 32, 8, 1, 4), 33: ("regs", 32, 8, 2, 8),
         64: ("regs", 32, 8, 2, 8), 65: ("regs", 32, 8, 3, 10),
         80: ("regs", 32, 8, 3, 10), 81: ("regs", 32, 16, 3, 6),
         96: ("regs", 32, 16, 3, 6), 97: ("regs", 32, 16, 4, 7),
         101: ("regs", 32, 16, 4, 7), 112: ("regs", 32, 16, 4, 7),
         113: ("regs", 32, 16, 4, 8), 128: ("regs", 32, 16, 4, 8),
         129: ("smem", 0, 0, 0, 0), 168: ("smem", 0, 0, 0, 0),
         238: ("smem", 0, 0, 0, 0)}


@pytest.mark.parametrize("m", sorted(PLANS))
def test_launch_plan(m):
    for dtype in (torch.float64, torch.float32):
        if dtype == torch.float64 and m > 168:
            with pytest.raises(ValueError):
                lu_cuda.launch_plan(m, dtype)
            continue
        p = lu_cuda.launch_plan(m, dtype)
        assert (p.variant, p.ty, p.tx, p.ry, p.rx) == PLANS[m]
        if p.variant == "regs":
            assert p.threads == p.ty * p.tx
            # the tile covers m, and the one before it in TILES does not
            assert p.ty * p.ry >= m and p.tx * p.rx >= m
            q = [t[1:] for t in lu_cuda.TILES].index((p.tx, p.ry, p.rx))
            assert q == 0 or lu_cuda.TILES[q - 1][0] < m
            # the strip of 32 rows (or, if larger, the step buffers), then
            # two pivot rows, perm and iperm
            values = max(32 * (m | 1), 2 * 32 * p.ry + p.tx * p.rx + 4)
            assert p.smem_bytes == values * dtype.itemsize + 4 * (2 + 2 * m)
        else:
            assert p.threads == 256


def test_launch_plan_refusals():
    with pytest.raises(ValueError):
        lu_cuda.launch_plan(0, torch.float64)
    with pytest.raises(TypeError):
        lu_cuda.launch_plan(8, torch.float16)
    # every register tile is used, and none beyond m = 128
    tiles = {(p.tx, p.ry, p.rx) for p in (
        lu_cuda.launch_plan(m, torch.float64) for m in range(1, 129))}
    assert tiles == {t[1:] for t in lu_cuda.TILES}
    assert lu_cuda.launch_plan(129, torch.float32).variant == "smem"


# --------------------------------------------------------------------------
# on a CUDA device: the hand-written kernel
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the hand-written kernel")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
# the tot mechanism's blocks, a ragged tiny size, the register tiles'
# edges (one and two 32-row slabs, the tiles' last m, the variant switch
# at 128), the shared-memory variant, the largest float32 size
@pytest.mark.parametrize("n,m", [(300, 80), (70, 101), (9, 3), (5, 1),
                                 (6, 15), (6, 16), (6, 17), (6, 31),
                                 (6, 32), (6, 33), (6, 64), (6, 65),
                                 (6, 81), (6, 96), (6, 97), (5, 112),
                                 (5, 113), (5, 127), (5, 128), (5, 129),
                                 (5, 300), (3, 238)])
@pytest.mark.parametrize("kind", ["dominant", "pivoting"])
def test_kernel_matches_plain_on_card(cuda, dtype, n, m, kind):
    if dtype == torch.float64 and m > 168:
        pytest.skip("beyond the float64 shared-memory bound")
    if dtype == torch.float32 and m == 300:
        pytest.skip("beyond the float32 shared-memory bound")
    a = dominant(n, m, m) if kind == "dominant" else needs_pivoting(n, m, m)
    a = torch.tensor(a, dtype=dtype, device=cuda)
    xk = lu_cuda.batched_inv(a)
    xp = lu.batched_inv_plain(a)
    torch.cuda.synchronize()
    assert (xk - xp).abs().max().item() <= KERNEL_TOL[dtype] * \
        xp.abs().max().item()
    # the same operations in the same order: equal to the last bit
    assert torch.equal(xk, xp)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [3, 33, 80, 101, 129])
def test_kernel_pivot_rule_on_card(cuda, dtype, m):
    """As test_plain_inverse_pivot_rule, embedded in an m x m identity
    (both variants): a tie |-2| = |2| takes the first row; a NaN in the
    pivot column is taken above all; a singular matrix gives non-finite
    output rather than an error."""
    tie = [[0.0, 1.0, 0.0], [-2.0, 0.0, 1.0], [2.0, 1.0, 1.0]]
    nan = [[1.0, 2.0, 3.0], [float("nan"), 4.0, 6.0], [0.0, 0.0, 1.0]]
    sing = [[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [0.0, 0.0, 1.0]]
    a = torch.eye(m, dtype=dtype).repeat(3, 1, 1)
    for q, blk in enumerate((tie, nan, sing)):
        a[q, :3, :3] = torch.tensor(blk, dtype=dtype)
    a = a.to(cuda)
    xk, xp = lu_cuda.batched_inv(a), lu.batched_inv_plain(a)
    torch.cuda.synchronize()
    assert torch.equal(xk[0], xp[0])
    np.testing.assert_allclose(xk[0, :3, :3].double().cpu().numpy(),
                               np.linalg.inv(np.array(tie)), rtol=1e-6)
    assert torch.equal(torch.isnan(xk), torch.isnan(xp))
    assert torch.equal(torch.nan_to_num(xk), torch.nan_to_num(xp))
    assert bool(torch.isnan(xk[1]).any())
    assert not bool(torch.isfinite(xk[2]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("m", sorted(PLANS))
def test_kernel_plan_matches_python_on_card(cuda, m):
    for dtype in (torch.float64, torch.float32):
        if dtype == torch.float64 and m > 168:
            continue
        got = lu_cuda.kernel_plan(m, dtype)
        assert got["plan"] == lu_cuda.launch_plan(m, dtype)
        assert got["blocks_per_sm"] >= (2 if m <= 80 else 1)


@pytest.mark.gpu
def test_kernel_refusals_and_dispatch_on_card(cuda):
    a = torch.tensor(dominant(4, 9, 1), device=cuda)
    lu_cuda.reset_counts()
    lu.batched_inv(a)
    assert lu_cuda.batched_inv.launches == 1
    with pytest.raises(ValueError):
        lu_cuda.batched_inv(a.transpose(1, 2))
    with pytest.raises(TypeError):
        lu_cuda.batched_inv(a.half())
    with pytest.raises(ValueError):
        lu_cuda.batched_inv(torch.zeros((2, 169, 169), dtype=torch.float64,
                                        device=cuda))
    # a singular matrix gives non-finite output, not an error
    s = torch.ones((1, 4, 4), dtype=torch.float64, device=cuda)
    assert not bool(torch.isfinite(lu_cuda.batched_inv(s)).all())
