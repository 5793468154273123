"""Faults planted in the program, underneath the harness: each breaks the
timed path as a faulty change could, and ``correct`` has to come out
false under it.  The tests install them at their small size; on the card
``python3 -m portbench.calibrate --fault <name>`` reads them at a cell's
own size.

* ``unchanged``: a minute step that returns its state unchanged;
* ``half_batch``: a minute step that leaves the second half of the
  ensemble's columns out (they keep their state);
* ``altered``: an answer altered where it is produced: one level of the
  first column's temperature, +0.5 K, after every minute;
* ``chem_unchanged``: the multiphase chemistry's substep
  (``integrate_column``: liq_parm and the two Ros3 solves) returns its
  input, so that only the chemistry is missing.

The cells run on one card, so no exchange between chips can be left out.
"""

from __future__ import annotations

import torch


def _patch(cls, attr, make):
    """Replace cls.attr by make(old); returns the undo."""
    old = cls.__dict__[attr]
    setattr(cls, attr, make(old))
    return lambda: setattr(cls, attr, old)


def _join(new, old, keep):
    """new's first keep columns, old's others."""
    out = {}
    for name in new.__dataclass_fields__:
        a, b = getattr(new, name), getattr(old, name)
        if a is None:
            out[name] = None
        elif torch.is_tensor(a):
            out[name] = torch.cat([a[:keep], b[keep:]])
        else:
            out[name] = _join(a, b, keep)
    return type(new)(**out)


def _model():
    from mistra_tpu_torch.model import Model
    return Model


def unchanged():
    return _patch(_model(), "minute_step", lambda old: (
        lambda self, state: state))


def half_batch():
    def make(old):
        def step(self, state):
            return _join(old(self, state), state, state.met.t.shape[0] // 2)
        return step
    return _patch(_model(), "minute_step", make)


def altered():
    def make(old):
        def step(self, state):
            new = old(self, state)
            t = new.met.t.clone()
            t[0, 5] += 0.5
            return new.replace(met=new.met.replace(t=t))
        return step
    return _patch(_model(), "minute_step", make)


def chem_unchanged():
    from mistra_tpu_torch.chemistry.driver_aq import MultiphaseDriver
    return _patch(MultiphaseDriver, "integrate_column", lambda old: (
        lambda self, state, dt: state.chem))


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered, "chem_unchanged": chem_unchanged}


def install(name: str):
    """Plant the fault name; returns the undo."""
    return FAULTS[name]()
