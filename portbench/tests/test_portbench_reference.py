"""The reference agrees with the port's plain path, and imports none of
it."""

from __future__ import annotations

import pytest

from portbench import compare, registry, run, traffic
from portbench.standins import write_inputs

from ._tiny import SMALL_TOT, tiny_root


@pytest.mark.parametrize("config, mix", [("btz96", "ens64"),
                                         ("multiphase", "ens8")])
def test_reference_minute_equals_the_port_plain_path(tmp_path, config, mix):
    """One minute of a noon and a midnight column on the tiny grid, on
    the CPU: the same start and the same state after the minute."""
    import mistra_tpu_torch as prog
    from portbench import reference as ref

    root = tiny_root(tmp_path, columns=2)
    spec = registry.config(config, root)
    m = registry.traffic(mix, root)
    inp, mech = write_inputs(spec["inputs"], str(tmp_path))
    pm = run.model_class("mistra_tpu_torch", spec)(
        run.build_config(prog, spec, inp, mech), device="cpu")
    rm = run.model_class("portbench.reference", spec)(
        run.build_config(ref, spec, inp, mech), device="cpu")
    ps = traffic.start(pm, 11, spec, m)
    rs = traffic.start(rm, 11, spec, m)
    assert compare.init_gap(ps, rs) == 0.0
    ps, rs = pm.minute_step(ps), rm.minute_step(rs)
    fields = dict(spec["compare"], ff={"field": "micro.ff",
                                       "scale": "column"})
    gaps = compare.field_gaps(ps, rs, fields, rm)
    assert all(g <= 1e-12 for g in gaps.values()), gaps
    assert spec["inputs"]["tot_mechanism"] in (None, SMALL_TOT)


def test_perturbation_is_seeded_and_sized():
    a = traffic.perturbations(2**31 + 5, 8, 30, 12, {"t_K": 0.1,
                                                     "q_rel": 0.005,
                                                     "modes": 3})
    b = traffic.perturbations(2**31 + 5, 8, 30, 12, {"t_K": 0.1,
                                                     "q_rel": 0.005,
                                                     "modes": 3})
    c = traffic.perturbations(6, 8, 30, 12, {"t_K": 0.1, "q_rel": 0.005,
                                            "modes": 3})
    assert (a[0] == b[0]).all() and (a[1] == b[1]).all()
    assert not (a[0] == c[0]).all()
    for d in a:
        assert (d[:, 0] == 0).all() and (d[:, 12:] == 0).all()
    assert 0.02 < abs(a[0]).max() < 0.6
