"""The Ros3 loop replayed from CUDA graphs (``rosenbrock.GraphedLoop``).

On the CPU: ``GasKernel.integrate`` runs the loop op by op (no graph is
captured or replayed, and ``ros3.iters`` counts its iterations), the
block solver's ``prepare`` is its phases in sequence with an inverse
between two, and the router writes an inverse into ``out``.  On a CUDA
device (``gpu``): the graph path against the op-by-op loop on the card,
bit for bit, for the tot-shaped stand-in (two inverses per iteration) at
99 and 792 cells in float64, the chem=T gas stand-in in float32 (the
multiphase driver's gas solve runs it so) and an unbinned mechanism (one
inverse); a second call with new inputs replays the same graphs.

The CUDA tests run on a GPU host without JAX and without the suite's
conftest:
    python -m pytest --noconftest -m gpu tests/test_torch_ros3_graph.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mistra_tpu_torch.chemistry import gas_kernel as tgk
from mistra_tpu_torch.chemistry import lu, lu_cuda
from mistra_tpu_torch.chemistry import mech as tmech
from mistra_tpu_torch.chemistry import rates as trates
from mistra_tpu_torch.chemistry import rosenbrock
from mistra_tpu_torch.utils import profiling

DT = 10.0
FIELDS = ("t", "nsteps", "done", "failed")


@pytest.fixture(scope="module")
def mechanisms(tmp_path_factory):
    """{name: mechanism}: the small multiphase stand-in (bins 1 and 2 of
    10) and its unbinned gas mechanism, the tot-shaped stand-in (4 bins
    of 80, gas core 101) and the chem=T gas stand-in (95 + 7 species)."""
    small = str(tmp_path_factory.mktemp("mech_small"))
    tot = str(tmp_path_factory.mktemp("mech_tot"))
    gas = str(tmp_path_factory.mktemp("mech_gas"))
    tmech.write_synthetic_multiphase_mechanism(small, 16, 10, seed=0)
    tmech.write_synthetic_multiphase_mechanism(tot)
    tmech.write_synthetic_gas_mechanism(gas)
    return {"small": tmech.load_multiphase_mechanism(small, bins=(1, 2)),
            "small_unbinned": tmech.load_gas_mechanism(small),
            "tot": tmech.load_multiphase_mechanism(tot, name="tot"),
            "gas": tmech.load_gas_mechanism(gas),
            "unbinned": tmech.load_gas_mechanism(tot)}


def inputs(kern, cells, seed):
    """(k, fix, y0) on the kernel's device for cells with te over 275-295
    K, air at 1 atm and log-normal concentrations, drawn from seed."""
    m = kern.mech
    rng = np.random.default_rng(seed)
    te = rng.uniform(275.0, 295.0, cells)
    air = 101325.0 / (8.314 * te)
    y0 = 1e-8 * rng.lognormal(0.0, 1.0, (cells, m.nvar))
    cols = {"O2": 0.21 * air, "N2": 0.79 * air, "H2O": np.full(cells, 0.5)}
    fix = np.stack([cols.get(s, np.full(cells, 1e-2)) for s in m.fixed], -1)

    def dev(x):
        return torch.tensor(x, dtype=kern.dtype, device=kern.device)

    env = trates.RateEnv(te=dev(te), aircc=dev(air * 6.022e17),
                         h2oppm=dev(np.full(cells, 1.2e4)),
                         pk=dev(np.full(cells, 101325.0)),
                         ph_rat=dev(np.full((cells, 47), 1.0e-5)))
    return kern.rate_constants(env, fix=dev(fix)), dev(fix), dev(y0)


# --------------------------------------------------------------------------
# on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["small", "small_unbinned"])
def test_prepare_is_its_phases_in_sequence(mechanisms, name):
    """The phases, an inverse between two, give prepare's factors bit for
    bit; each hands the next inverse a contiguous [N, m, m] batch."""
    kern = tgk.GasKernel(mechanisms[name], dtype=torch.float64, device="cpu")
    block = kern.block
    k, fix, y = inputs(kern, 5, 3)
    jac = block.assemble(kern.kw_weights(y, k, fix))
    ghinv = 10.0 ** torch.linspace(-1.0, 4.0, 5, dtype=torch.float64)
    want = block.prepare(jac, ghinv)

    first, *rest = block.phases()
    assert len(rest) == (2 if block.nbin else 1)
    part, a = first(jac, ghinv)
    shapes = []
    for phase in rest:
        shapes.append(tuple(a.shape))
        assert a.is_contiguous()
        part, a = phase(part, lu.batched_inv(a))
    assert a is None
    nb, ma, mg = block.nbin, block.ma, block.mg
    assert shapes == ([(5 * nb, ma, ma), (5, mg, mg)] if nb
                      else [(5, mg, mg)])
    for f, got, ref in zip(want._fields, part, want):
        if ref is None:
            assert got is None, f
        else:
            assert torch.equal(got, ref), f


@pytest.mark.parametrize("name", ["small", "small_unbinned"])
def test_cpu_integrate_runs_op_by_op(mechanisms, name):
    """On the CPU no graph is captured or replayed: ros3.iters is the
    loop's iterations, nsteps.max(), in COUNTS and in the tracer."""
    kern = tgk.GasKernel(mechanisms[name], dtype=torch.float64, device="cpu")
    k, fix, y0 = inputs(kern, 4, 1)
    rosenbrock.reset_counts()
    label = f"test_cpu_integrate_runs_op_by_op.{name}"
    with profiling.tracing(), profiling.span(label):
        y, info = kern.integrate(y0, k, fix, DT)
    iters = int(info["nsteps"].max())
    assert iters > 0 and bool(info["done"].all())
    assert rosenbrock.COUNTS == {"ros3.iters": iters,
                                 "ros3.graph_iters": 0,
                                 "ros3.graph_captures": 0}
    counts = profiling.summary()[label]["counts"]
    assert counts["ros3.iters"] == iters
    assert counts["sync.ros3"] == iters + 1
    assert "ros3.graph_iters" not in counts
    assert kern._graphs == {}


def test_router_writes_out_on_cpu():
    rng = np.random.default_rng(2)
    a = torch.tensor(rng.random((6, 7, 7)) + 7.0 * np.eye(7))
    out = torch.empty_like(a)
    assert lu.batched_inv(a, out=out) is out
    assert torch.equal(out, lu.batched_inv_plain(a))


# --------------------------------------------------------------------------
# on a CUDA device
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the graphs and the inverse "
                    "kernel")
    return torch.device("cuda")


def op_by_op(kern, k, fix, y0):
    """The loop op by op on the card, and the inverse's launches."""
    lu_cuda.reset_counts()
    y, info = rosenbrock.integrate(*kern._problem(k, fix), y0, DT)
    return y, info, lu_cuda.batched_inv.launches


@pytest.mark.gpu
@pytest.mark.parametrize("name,cells,dtype", [
    ("tot", 99, torch.float64), ("tot", 792, torch.float64),
    ("gas", 392, torch.float32), ("unbinned", 64, torch.float64)])
def test_graphs_match_the_op_by_op_loop_on_card(cuda, mechanisms, name,
                                                cells, dtype):
    kern = tgk.GasKernel(mechanisms[name], dtype=dtype, device=cuda)
    per_iter = 2 if kern.block.nbin else 1
    assert len(kern.block.phases()) == per_iter + 1
    rosenbrock.reset_counts()
    for call, seed in enumerate((0, 1)):
        k, fix, y0 = inputs(kern, cells, seed)
        y_ref, info_ref, launches_ref = op_by_op(kern, k, fix, y0)
        iters = int(info_ref["nsteps"].max())
        assert launches_ref == per_iter * iters
        rosenbrock.reset_counts()
        lu_cuda.reset_counts()
        y, info = kern.integrate(y0, k, fix, DT)
        assert lu_cuda.batched_inv.launches == per_iter * iters
        assert torch.equal(y, y_ref), f"call {call}: y differs"
        for f in FIELDS:
            assert torch.equal(info[f], info_ref[f]), f"call {call}: {f}"
        assert int(info["n_failed"]) == int(info_ref["n_failed"]) == 0
        # the first call runs one iteration op by op, then captures; the
        # second replays those graphs
        assert rosenbrock.COUNTS == {
            "ros3.iters": iters, "ros3.graph_iters": iters - (call == 0),
            "ros3.graph_captures": int(call == 0)}
        assert len(kern._graphs) == 1


@pytest.mark.gpu
def test_inverse_out_refusals_on_card(cuda):
    a = torch.eye(4, dtype=torch.float64, device=cuda).repeat(3, 1, 1)
    out = torch.empty_like(a)
    assert lu_cuda.batched_inv(a, out=out) is out
    assert torch.equal(out, a)
    for bad in (out.float(), out[:2], out.transpose(1, 2), out.cpu()):
        with pytest.raises(ValueError):
            lu_cuda.batched_inv(a, out=bad)
