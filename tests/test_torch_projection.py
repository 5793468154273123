"""``physics.projection.oneD_dist`` against the JAX package's on random
spectra of two columns: the tests' tiny grid and the production grid's
bins on a few levels, float64, within 1e-12 of the largest class."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mistra_tpu_torch as pt
from mistra_tpu.config import GridParams, MistraConfig
from mistra_tpu.grids import make_grids
from mistra_tpu.physics.projection import oneD_dist as jax_oneD_dist
from mistra_tpu_torch.physics.projection import oneD_dist


@pytest.mark.parametrize("grid", [
    dict(nf=20, n_extra=10, nka=16, nkt=16, nb=8),
    dict(nf=12, n_extra=4, nka=70, nkt=70, nb=8)])
def test_oneD_dist_matches_jax(grid):
    jg = make_grids(MistraConfig(grid=GridParams(**grid))).micro
    tg = pt.make_grids(pt.MistraConfig(grid=pt.GridParams(**grid))).micro
    nkt, nka, n, nf = grid["nkt"], grid["nka"], grid["nf"] + \
        grid["n_extra"], grid["nf"]
    rng = np.random.default_rng(3)
    ff = rng.uniform(0.0, 1.0, (2, nkt, nka, n)) \
        * 10.0 ** rng.uniform(-6.0, 2.0, (2, nkt, nka, n))
    got = oneD_dist(torch.from_numpy(ff), tg, nf)
    assert got.shape == (2, nka - 1, nf) and got.dtype == torch.float64
    for c in range(2):
        want = np.asarray(jax_oneD_dist(ff[c], jg, nf))
        assert want.shape == (nka - 1, nf)
        err = np.abs(got[c].numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-12, err
    assert torch.equal(got[:, :, 0], torch.zeros_like(got[:, :, 0]))
