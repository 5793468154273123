"""Bott advection of the PyTorch port: the plain torch versions against the
JAX package's banded reference, dispatch by device, the identities the
CUDA kernels' design rests on (searched walk, trimmed deposit), and the
hand-written CUDA kernels against the plain versions (on a CUDA device
only).

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


def adversarial(seed, rows=64, nkt=NKT):
    """Rows that stress the walk's searches and the deposit, cycling
    through: mixed signs with zeros; zeros and ties in u (flat stretches
    of S); huge and tiny |u| (2^-20..2^20, so that 1/u and every prefix
    sum are exact in double and the walk, ill-conditioned against the
    summation order at such spreads, compares exactly); all positive to
    the grid top; all negative to the bottom; alternating signs; walks
    beyond any band (|u| 20..80); slow rows.  Spectra with sub-YMIN bins,
    rows without a significant bin and rows of significant bins only."""
    rng = np.random.default_rng(seed)
    u = np.empty((rows, nkt))
    sign = rng.choice([-1.0, 1.0], (rows, nkt))
    for r in range(rows):
        kind = r % 8
        if kind == 0:
            u[r] = rng.uniform(-3.0, 3.0, nkt)
            u[r, rng.uniform(size=nkt) < 0.15] = 0.0
        elif kind == 1:
            u[r] = rng.choice([-2.0, -1.0, 0.0, 0.0, 0.0, 1.0, 2.0], nkt)
        elif kind == 2:
            u[r] = sign[r] * 2.0 ** rng.integers(-20, 21, nkt)
        elif kind == 3:
            u[r] = rng.uniform(0.5, 5.0, nkt)
        elif kind == 4:
            u[r] = -rng.uniform(0.5, 5.0, nkt)
        elif kind == 5:
            u[r] = (np.where(np.arange(nkt) % 3 == 2, -1.0, 1.0)
                    * rng.uniform(0.1, 2.0, nkt))
        elif kind == 6:
            u[r] = sign[r, 0] * rng.uniform(20.0, 80.0, nkt)
        else:
            u[r] = rng.uniform(-1.0, 1.0, nkt) * 1e-6
    z = rng.lognormal(0.0, 2.0, (rows, nkt))
    z[rng.uniform(size=z.shape) < 0.3] = 0.0
    z[rng.uniform(size=z.shape) < 0.05] = 1e-35
    z[1::5] = 0.0
    z[2::7] = rng.uniform(0.5, 1.0, z[2::7].shape)
    e = np.exp(np.linspace(-20.0, 8.0, nkt))
    return u, z, e


def row_scale(z):
    return np.maximum(np.abs(z).max(axis=-1, keepdims=True), 1e-300)


def dwsum_scale(psi, z, e):
    """Per-row magnitude of the terms of dwsum: sum_k (|psi_k|+|z_k|) e_k."""
    tiny = max(1e-300, torch.finfo(psi.dtype).tiny)
    return ((psi.abs() + z.abs()) * e).sum(dim=-1).clamp(min=tiny)


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
# the identities of the kernels' design, in plain torch
# --------------------------------------------------------------------------

def searched_counts(S, target, J):
    """count = lower bound of target in the non-decreasing S[i, i + n),
    n = min(J, nkt - i), by binary search."""
    nkt = S.shape[-1]
    i = torch.arange(nkt)
    idx = torch.searchsorted(S.contiguous(), target.contiguous(),
                             side="left")
    return torch.minimum(torch.clamp(idx - i, min=0),
                         torch.clamp(nkt - i, max=J))


def scanned_runs(pos, J):
    """run = distance from bin i+1 to the next bin with !(u > 0) (nkt if
    none), clipped to J, from a backward min-scan of their indices."""
    nkt = pos.shape[-1]
    i = torch.arange(nkt)
    idx = torch.where(pos, nkt, i)
    nxt = torch.flip(torch.cummin(torch.flip(idx, [-1]), dim=-1).values,
                     [-1])
    after = torch.cat([nxt[..., 1:], torch.full_like(nxt[..., :1], nkt)],
                      dim=-1)
    return torch.clamp(after - (i + 1), max=J)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J", [16, 32, 70])
@pytest.mark.parametrize("dt", [1.0, 10.0])
def test_searched_walk_equals_band_loops(dtype, J, dt):
    """The kernels' binary-search count and scanned run are the integers of
    the plain walk's band loops, rightward and mirrored."""
    u, _, _ = adversarial(J, rows=64)
    u = torch.tensor(u, dtype=dtype)
    for uu in (u, -u.flip(-1)):
        pos, S, P = tg._walk_prefix(uu)
        assert (S[..., 1:] >= S[..., :-1]).all()
        target = P + (dt - tg._WALK_EPS)
        count, run = tg._walk_searches(S, target, pos, J)
        assert count.max() > 1 and run.max() == min(J, NKT - 1)
        assert torch.equal(searched_counts(S, target, J), count)
        assert torch.equal(scanned_runs(pos, J), run)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J", [16, 32, 70])
def test_trimmed_deposit_is_the_full_band_deposit(dtype, J):
    """The deposit gathered over |d| <= the row's reach (the largest
    displacement of a significant source) is the full band's, to the bit:
    the skipped terms are exact zeros.  No displacement lies beyond the
    band, so the kernels' overshoot ballot finds none on these rows."""
    u, z, _ = adversarial(50 + J, rows=64)
    u, z = torch.tensor(u, dtype=dtype), torch.tensor(z, dtype=dtype)
    k_low, k_high, w_lo, w_hi = tg._bott_split(10.0, u, z, J)
    i = torch.arange(NKT)
    D = J + 2
    sig = z >= tg.YMIN
    dl, dh = (k_low - i).abs(), (k_high - i).abs()
    assert not (sig & ((dl > D) | (dh > D))).any()
    reach = torch.maximum(torch.where(sig, dl, 0).amax(-1),
                          torch.where(sig, dh, 0).amax(-1))
    assert (reach < D).any() and (reach > 2).any()
    out = torch.empty_like(z)
    for r in range(z.shape[0]):
        acc = torch.zeros(NKT, dtype=dtype)
        for d in range(-int(reach[r]), int(reach[r]) + 1):
            v = (torch.where(k_low[r] - i == d, w_lo[r], 0.0)
                 + torch.where(k_high[r] - i == d, w_hi[r], 0.0))
            acc = acc + torch.roll(v, d)
        out[r] = acc
    assert torch.equal(out, tg.bott_advect_plain(10.0, u, z, J))


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
# the production bins; the tiny grid's 16 bins in a ragged last block; bin
# counts that are not a multiple of the warp (1, 33, 300: a lane owns 10)
@pytest.mark.parametrize("rows,nkt", [(512, NKT), (33, 16), (40, 1),
                                      (40, 33), (7, 300)])
# the microphysics mix; the adversarial rows (ties, 2^-20..2^20, rows to
# the grid top, walks past the band, rows without a significant bin)
@pytest.mark.parametrize("make", [fields, adversarial])
def test_kernels_match_plain_on_card(cuda, dtype, J, rows, nkt, make):
    u, z, e = (torch.tensor(a, dtype=dtype, device=cuda)
               for a in make(7 + J, rows=rows, nkt=nkt))
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
