"""Projection of the 2-D particle spectrum onto the 1-D output radius grid
(reference ``oneD_dist_jjb``, str.f90:7571-7639); torch counterpart of
``mistra_tpu.physics.projection`` with a leading column axis."""

from __future__ import annotations

import numpy as np
import torch


def oneD_dist(ff, micro_grid, nf):
    """Sum each level's (nkt, nka) bins into the 1-D rpw radius classes.

    ff: [B, nkt, nka, n]; micro_grid: the numpy ``MicroGrid``
    (``model.grids.micro``).  Returns part1D [B, nka-1, nf] for levels
    1..nf (0-based), the level-0 column zero, as the reference's output
    block.
    """
    rq = np.asarray(micro_grid.rq)            # [nkt, nka]
    rpw = np.asarray(micro_grid.rpw)          # [nka]
    nka = rpw.shape[0]
    # target class per 2-D bin: smallest ij with rq <= rpw[ij+1]
    idx = np.clip(np.searchsorted(rpw[1:], rq, side="left"), 0, nka - 2)
    onehot = torch.as_tensor(
        (idx[:, :, None] == np.arange(nka - 1)[None, None, :])
        .astype(np.float64), dtype=ff.dtype, device=ff.device)
    part = torch.einsum("btkz,tkc->bcz", ff[..., 1:nf], onehot)
    return torch.cat([part.new_zeros(part.shape[:2] + (1,)), part], dim=2)
