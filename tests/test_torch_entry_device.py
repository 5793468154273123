"""The port's entry points run on the card unless the caller asks for the
CPU: ``Model`` (chem=F, chem=T with the gas-phase driver and chem=T with
the multiphase driver; nuc=T, mic=F and isurf=1), ``BoxModel`` (box and
chamber), ``GasKernel`` and ``BlockArrowSolver`` built without a device
take CUDA, and on a host without a card they raise instead of falling
back to the CPU (the run harness's ``cli.main`` too, unless given
``--platform cpu``); a chem=T model builds its chemistry driver's kernels and
stage solvers on its own device, and a box its model's."""

from __future__ import annotations

import pytest
import torch

import mistra_tpu_torch as pt
from mistra_tpu_torch import cli
from mistra_tpu_torch.boxmodel import write_synthetic_chamber_dat
from mistra_tpu_torch.chemistry import mech as tmech
from mistra_tpu_torch.chemistry.block_solver import BlockArrowSolver
from mistra_tpu_torch.chemistry.gas_kernel import GasKernel
from mistra_tpu_torch.photolysis.tables import \
    write_synthetic_photolysis_tables
from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
from mistra_tpu_torch.radiation.tables import \
    write_synthetic_radiation_tables


def model(tmp_path, chem=False, multiphase=False, settings=None, box=False,
          **kw):
    write_synthetic_clarke_table(tmp_path)
    extra = {}
    if chem:
        write_synthetic_radiation_tables(tmp_path)
        write_synthetic_photolysis_tables(tmp_path)
        if multiphase:
            tmech.write_synthetic_tot_mechanism(str(tmp_path), 12, 25)
        else:
            tmech.write_synthetic_gas_mechanism(str(tmp_path), 20)
        extra = dict(nkc_l=4 if multiphase else 0, mechdir=str(tmp_path),
                     zinv=100.0)
    extra = dict(dict(chem=chem, mic=True), **extra, **(settings or {}))
    cfg = pt.MistraConfig(grid=pt.GridParams(nf=20, n_extra=10, nka=16,
                                             nkt=16, nb=8),
                          inpdir=str(tmp_path), **extra)
    if box:
        (tmp_path / "photolys").mkdir(exist_ok=True)
        write_synthetic_chamber_dat(tmp_path / "photolys")
        return pt.BoxModel(cfg, **kw)
    return pt.Model(cfg, **kw)


def mechanism(tmp_path):
    tmech.write_synthetic_multiphase_mechanism(str(tmp_path), 16, 10, seed=0)
    return tmech.load_multiphase_mechanism(str(tmp_path), bins=(1, 2))


ENTRY_POINTS = {
    "Model": model,
    "Model chem=T": lambda p, **kw: model(p, chem=True, **kw),
    "Model chem=T nkc_l=4": lambda p, **kw: model(p, chem=True,
                                                  multiphase=True, **kw),
    "Model nuc=T": lambda p, **kw: model(p, chem=True,
                                         settings=dict(nuc=True), **kw),
    "Model mic=F": lambda p, **kw: model(p, settings=dict(mic=False), **kw),
    "Model isurf=1": lambda p, **kw: model(p, settings=dict(isurf=1), **kw),
    "BoxModel box": lambda p, **kw: model(p, chem=True, box=True,
                                          settings=dict(box=True), **kw),
    "BoxModel chamber": lambda p, **kw: model(
        p, chem=True, box=True, settings=dict(chamber=True, mic=False),
        **kw),
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


def test_chem_model_builds_its_drivers_on_its_device(tmp_path):
    m = model(tmp_path, chem=True, device="cpu")
    state = m.init_state(1)
    kern = m._chemistry.kernel
    assert kern.device == kern.block.device == m.device == torch.device("cpu")
    assert kern.stoich.device == m._chemistry.am3.device == m.device
    assert state.chem.sgas.device == m.device
    assert m._photolysis is not None


def test_multiphase_model_builds_its_drivers_on_its_device(tmp_path):
    """chem=T with nkc_l=4: the multiphase driver, whose float64 tot kernel
    and gas-above kernel, their stage solvers and the state all live on
    the model's device."""
    m = model(tmp_path, chem=True, multiphase=True, device="cpu")
    state = m.init_state(1)
    drv = m._chemistry
    assert type(drv).__name__ == "MultiphaseDriver"
    tot, gas = drv.tot_kernel, drv.kernel
    assert tot.dtype == torch.float64 and tot.block.nbin == 4
    assert tot.device == tot.block.device == gas.device == m.device
    assert tot.stoich.device == drv.conc_es.device == m.device
    assert state.chem.conc.device == state.chem.cloud.device == m.device
    assert state.chem.conc.shape[1] == drv.tot.nvar


def test_box_model_builds_on_its_device(tmp_path):
    """A box with the multiphase driver: its model, drivers and state on
    the box's device; BoxModel refuses a column configuration."""
    bm = model(tmp_path, chem=True, multiphase=True, box=True,
               settings=dict(box=True), device="cpu")
    state = bm.init_state(2)
    assert bm.device == bm.model.device == torch.device("cpu")
    assert type(bm.model._chemistry).__name__ == "MultiphaseDriver"
    assert state.chem.conc.device == bm.device
    with pytest.raises(ValueError, match="box or"):
        pt.BoxModel(bm.model.cfg.__class__(inpdir=str(tmp_path)),
                    device="cpu")


def test_cli_runs_on_the_card_unless_told_cpu(tmp_path, monkeypatch):
    """Without a card and without --platform cpu, cli.main raises before
    it builds a model or writes anything: it does not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(pt.Model, "__init__",
                        lambda *a, **k: built.append(a))
    for platform in ([], ["--platform", "cuda"], ["--platform", "gpu"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--outdir", str(tmp_path / "out"), *platform])
    assert not built and not (tmp_path / "out").exists()
    assert cli.device_for("cpu") == torch.device("cpu")
