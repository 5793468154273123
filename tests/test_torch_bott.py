"""Bott advection of the PyTorch port: the plain torch versions against the
JAX package's banded reference, dispatch by device, and the hand-written
CUDA kernels against the plain versions (on a CUDA device only).

The CUDA tests run on a GPU host without JAX and without the suite's
conftest (which configures JAX):
    python -m pytest --noconftest -m gpu tests/test_torch_bott.py
so this file imports JAX only inside the tests that compare with it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mistra_tpu_torch.physics import bott_cuda
from mistra_tpu_torch.physics import growth as tg

NKT = 70
# float64, same formulas: the two differ only in the order of the prefix
# sums and row reductions (XLA's associative scan, a sequential cumsum).
# The walk subtracts prefix sums of 1/u, which reach ~1e4 where |u| is
# small, so an ulp of the sum (~1e-12 s) moves a position by |u| times that
# (|u| <= 40 here): relative to the row's largest bin (advect) or, for
# dwsum (gained minus lost water mass), to the magnitudes it is made of,
# sum_k (|psi_k| + |z_k|) e_k, 1e-10 covers that with a margin
TOL_F64 = 1e-10
# kernel against plain on the card (chip_smoke.py states the same)
KERNEL_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


def fields(seed, rows=64, nkt=NKT):
    """The field mix of tests/test_microphysics.py (mixed-sign u with
    zeros, fast +-5 rows, a slow 1e-8 row) plus +-40 rows that walk past
    any band, on sparse positive spectra with sub-YMIN bins."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-3.0, 3.0, (rows, nkt))
    u[rng.uniform(size=u.shape) < 0.15] = 0.0
    u[0, :] = 5.0
    u[1, :] = -5.0
    u[2, :] = 1e-8
    u[3, :] = 40.0
    u[4, :] = -40.0
    z = rng.uniform(0.0, 1.0, (rows, nkt)) * (rng.uniform(size=(rows, nkt))
                                              < 0.8)
    z[5, ::7] = 1e-35
    e = np.exp(np.linspace(-20.0, 8.0, nkt))
    return u, z, e


def row_scale(z):
    return np.maximum(np.abs(z).max(axis=-1, keepdims=True), 1e-300)


def dwsum_scale(psi, z, e):
    """Per-row magnitude of the terms of dwsum: sum_k (|psi_k|+|z_k|) e_k."""
    return ((psi.abs() + z.abs()) * e).sum(dim=-1).clamp(min=1e-300)


@pytest.fixture(scope="module")
def jax_growth():
    """The JAX package's growth module and jax.numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from mistra_tpu.physics import growth
    return growth, jnp


@pytest.mark.parametrize("J", [16, 32, 70])
@pytest.mark.parametrize("dt", [1.0, 10.0])
def test_advect_plain_matches_jax(jax_growth, J, dt):
    jg, jnp = jax_growth
    u, z, _ = fields(J)
    want = np.asarray(jg.bott_bin_advection(dt, jnp.asarray(u),
                                            jnp.asarray(z), band=J))
    got = tg.bott_bin_advection(dt, torch.tensor(u), torch.tensor(z), J)
    assert (np.abs(got.numpy() - want) / row_scale(z)).max() <= TOL_F64


@pytest.mark.parametrize("J", [16, 32, 70])
@pytest.mark.parametrize("dt", [1.0, 10.0])
def test_dwsum_plain_matches_jax(jax_growth, J, dt):
    jg, jnp = jax_growth
    u, z, e = fields(100 + J)
    want = np.asarray(jg.bott_dwsum(dt, jnp.asarray(u), jnp.asarray(z),
                                    jnp.asarray(e), band=J))
    got = tg.bott_dwsum(dt, torch.tensor(u), torch.tensor(z),
                        torch.tensor(e), J)
    psi = tg.bott_advect_plain(dt, torch.tensor(u), torch.tensor(z), J)
    scale = dwsum_scale(psi, torch.tensor(z), torch.tensor(e)).numpy()
    assert (np.abs(got.numpy() - want) / scale).max() <= TOL_F64


def test_advect_conserves_mass_and_batches():
    u, z, _ = fields(3, rows=24)
    ut, zt = torch.tensor(u), torch.tensor(z)
    out = tg.bott_bin_advection(10.0, ut, zt, 32)
    sig = np.where(z >= tg.YMIN, z, 0.0).sum(axis=-1)
    assert np.abs(out.numpy().sum(axis=-1) - sig).max() <= 1e-13 * sig.max()
    # leading axes are independent rows
    out4 = tg.bott_bin_advection(10.0, ut.reshape(2, 3, 4, NKT),
                                 zt.reshape(2, 3, 4, NKT), 32)
    assert torch.equal(out4.reshape(24, NKT), out)


def test_cpu_tensors_take_the_plain_version():
    u, z, e = (torch.tensor(a) for a in fields(4, rows=8))
    bott_cuda.reset_counts()
    assert torch.equal(tg.bott_bin_advection(1.0, u, z, 32),
                       tg.bott_advect_plain(1.0, u, z, 32))
    assert torch.equal(tg.bott_dwsum(1.0, u, z, e, 32),
                       tg.bott_dwsum_plain(1.0, u, z, e, 32))
    assert bott_cuda.bott_advect.launches == 0
    assert bott_cuda.bott_dwsum.launches == 0


def test_kernel_wrappers_refuse_cpu_and_other_devices():
    u, z, e = (torch.tensor(a) for a in fields(5, rows=8))
    with pytest.raises(ValueError):
        bott_cuda.bott_advect(1.0, u, z, 32)
    with pytest.raises(ValueError):
        bott_cuda.bott_dwsum(1.0, u, z, e, 32)
    with pytest.raises(ValueError):
        tg.bott_bin_advection(1.0, u.to("meta"), z.to("meta"), 32)


# --------------------------------------------------------------------------
# on a CUDA device: the hand-written kernels
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the hand-written kernels")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J", [32, 70])
# the production bins; the tiny grid's 16 bins in a ragged last block; one
# row per block (more bins than the block's 256 threads)
@pytest.mark.parametrize("rows,nkt", [(512, NKT), (33, 16), (7, 300)])
def test_kernels_match_plain_on_card(cuda, dtype, J, rows, nkt):
    u, z, e = (torch.tensor(a, dtype=dtype, device=cuda)
               for a in fields(7 + J, rows=rows, nkt=nkt))
    zmax = z.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    psi_k = bott_cuda.bott_advect(10.0, u, z, J)
    psi_p = tg.bott_advect_plain(10.0, u, z, J)
    assert ((psi_k - psi_p).abs() / zmax).max().item() <= KERNEL_TOL[dtype]
    ze = dwsum_scale(psi_p, z, e)
    dw_k = bott_cuda.bott_dwsum(10.0, u, z, e, J)
    dw_p = tg.bott_dwsum_plain(10.0, u, z, e, J)
    assert ((dw_k - dw_p).abs() / ze).max().item() <= KERNEL_TOL[dtype]


@pytest.mark.gpu
def test_dispatch_on_card_reaches_kernel(cuda):
    u, z, e = (torch.tensor(a, device=cuda) for a in fields(12, rows=16))
    bott_cuda.reset_counts()
    tg.bott_bin_advection(10.0, u, z, 32)
    tg.bott_dwsum(10.0, u, z, e, 32)
    assert bott_cuda.bott_advect.launches == 1
    assert bott_cuda.bott_dwsum.launches == 1
    with pytest.raises(ValueError):
        tg.bott_bin_advection(10.0, u.t(), z.t(), 32)
    with pytest.raises(TypeError):
        tg.bott_bin_advection(10.0, u.half(), z.half(), 32)
