"""Two nuc=T multiphase minutes (nkc_l=4, mic=T, both mechanisms) with
the feedback of the new particles into the particle grid (ifeed=1) of a
noon and a midnight column, the PyTorch port against the jitted JAX
minute.  Tiny grid, the small tot stand-in, radiation and photolysis on.

The feedback puts the new particles into the smallest dry bin, and in the
second minute kon carries a trace of them into the droplet classes of
chemistry bin 3, with konc moving a trace of each dissolved species along:
1e-35 to 1e-22 mol/m3, a few molecules per m3 or fewer, 17 to 30 decades
below the species' largest value in the gas phase or any bin.  A
rounding-level change of the particles (1e-12 of ff's scale) moves such a
trace by its own size, in the port against itself as in the port against
JAX, so a row of such traces cannot be held to 1e-6 of its own largest
value.  Each concentration row is held to 1e-6 of the larger of its own
largest value and 1e-10 of its species' largest value over the gas phase
and the four bins: a difference above 1e-16 of the species' scale fails.
Every other field is held as ``assert_state_close`` holds it; the minutes
at the defaults (ifeed=0), where no such trace arises, are held with no
floor in test_torch_nucleation_multiphase.py."""

from __future__ import annotations

import jax
import numpy as np

from _torch_parity import (assert_close, assert_equal_int, assert_rows_close,
                           assert_substate_close, at_noon, make_models,
                           to_numpy, to_port_columns)

TOL = 1e-6
# a concentration row's scale is at least this share of its species'
# largest value over the gas phase and the four bins
FAMILY_FLOOR = 1e-10


def family_scales(n2i, conc):
    """Each row's species' largest |value| over the gas phase and the four
    bins of conc [..., nvar, n] (a dissolved species Xl<b> belongs to the
    family of X)."""
    def stem(name):
        return name[:-2] if len(name) > 2 and name[-2] == "l" \
            and name[-1] in "1234" else name
    row_max = np.abs(conc).max(axis=tuple(i for i in range(conc.ndim)
                                          if i != conc.ndim - 2))
    fam = {}
    for name, i in n2i.items():
        fam[stem(name)] = max(fam.get(stem(name), 0.0), row_max[i])
    out = np.zeros_like(row_max)
    for name, i in n2i.items():
        out[i] = fam[stem(name)]
    return out


def test_two_feedback_minutes_match_jax(tmp_path_factory):
    jm, tm, js = make_models(tmp_path_factory.mktemp("inp"), radiation=True,
                             mechdir=tmp_path_factory.mktemp("mech"),
                             multiphase=True, nuc=True, ifeed=1)
    tm.init_state(1)
    step = jax.jit(jm.minute_step)
    states = [at_noon(jm, js), js]
    ts0 = ts = to_port_columns(states)
    for _ in range(2):
        states = [step(s) for s in states]
        ts = tm.minute_step(ts)
    assert ts.micro.ff[:, :, 0].sum() > ts0.micro.ff[:, :, 0].sum()

    want = np.stack([np.asarray(s.chem.conc) for s in states])
    got = ts.chem.conc.numpy()
    scale = np.maximum(np.maximum(np.abs(want).max(axis=(0, 2)),
                                  np.abs(got).max(axis=(0, 2))),
                       FAMILY_FLOOR
                       * family_scales(tm._chemistry.tot_n2i, want))
    err = np.abs(got - want).max(axis=(0, 2)) / np.where(scale > 0.0,
                                                         scale, 1.0)
    worst = int(err.argmax())
    assert err[worst] <= TOL, f"conc row {worst}: {err[worst]:.3e}"
    for c, s in enumerate(states):
        w, one = to_numpy(s), ts.map(lambda x: x[c:c + 1])
        for sub in ("met", "turb", "surf", "micro", "rad", "tim"):
            assert_substate_close(getattr(w, sub), getattr(one, sub), TOL,
                                  sub)
        assert_rows_close(w.chem.photol_j, one.chem.photol_j, TOL,
                          "photol_j")
        assert_close(w.chem.vg, one.chem.vg, TOL, "vg")
        assert_equal_int(w.chem.nonconv, one.chem.nonconv, "nonconv")
        assert_equal_int(w.chem.cloud, one.chem.cloud, "cloud")
