"""The port's entry points run on the card unless the caller asks for the
CPU: ``Model``, ``GasKernel`` and ``BlockArrowSolver`` built without a
device take CUDA, and on a host without a card they raise instead of
falling back to the CPU."""

from __future__ import annotations

import pytest
import torch

import mistra_tpu_torch as pt
from mistra_tpu_torch.chemistry import mech as tmech
from mistra_tpu_torch.chemistry.block_solver import BlockArrowSolver
from mistra_tpu_torch.chemistry.gas_kernel import GasKernel
from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table


def model(tmp_path, **kw):
    write_synthetic_clarke_table(tmp_path)
    cfg = pt.MistraConfig(grid=pt.GridParams(nf=20, n_extra=10, nka=16,
                                             nkt=16, nb=8),
                          chem=False, mic=True, inpdir=str(tmp_path))
    return pt.Model(cfg, **kw)


def mechanism(tmp_path):
    tmech.write_synthetic_multiphase_mechanism(str(tmp_path), 16, 10, seed=0)
    return tmech.load_multiphase_mechanism(str(tmp_path), bins=(1, 2))


ENTRY_POINTS = {
    "Model": model,
    "GasKernel": lambda p, **kw: GasKernel(mechanism(p), **kw),
    "BlockArrowSolver": lambda p, **kw: BlockArrowSolver(mechanism(p), **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(tmp_path, name):
    make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert make(tmp_path).device == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(tmp_path)
    assert make(tmp_path, device="cpu").device == torch.device("cpu")
