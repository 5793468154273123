"""The comparison that decides ``correct``.

The reference (``reference/``, the frozen plain path) follows the program
minute by minute from the program's own state, since a column minute
depends on the whole state before it:

* ``init``: the reference builds the ensemble's start itself (its own
  ``init_state``, the same perturbation and split, from the same input
  files) and it is held against the program's start, every floating
  field of every column;
* the window's last minute: the reference steps the program's state from
  before that minute, and the program's state after it is held against
  the reference's, quantity by quantity (the configuration's
  ``compare``: a field, or a weighted sum of one; ``quantity``), every
  column.

Each number is the widest gap of its quantity: |program - reference|
over a scale, the largest |reference| of the same column (``"scale":
"column"``) or of the same row, a species or J slot, over all columns and
levels (``"row"``), floored at ``SCALE_FLOOR``.  A gap that is not finite
is infinite and fails.

The controls (the configuration's ``controls``) are the reference in the
program's place, in the nearest precision below one that the
configuration states: its state held in bfloat16 between the steps
(``control_minute``), its float32 matrix products in TF32 (``tf32``), or
a setting changed (the tot solve in float32 where it runs in float64).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

SCALE_FLOOR = 1e-30


def get(state, path: str):
    for part in path.split("."):
        state = getattr(state, part) if state is not None else None
    return state


def quantity(state, spec: dict, model=None) -> torch.Tensor:
    """The compared quantity of state that a configuration's ``compare``
    entry describes: the field at ``spec["field"]``, or (in float64) its
    sum over the dimensions ``spec["sum"]``, each entry first weighted by
    ``spec["weights"]``: ``{"of": <path on the reference model>, "dim":
    <the field's dimension it runs along>}``.  ff [B, nkt, nka, n] summed
    over dimension 1 is ``ff_number`` (what the Bott advection along the
    water-mass bins conserves); weighted by the water-mass bins' centres
    (``grids.micro.e``) and summed over 1 and 2 it is ``ff_water``, each
    level's liquid water."""
    x = get(state, spec["field"])
    if "sum" not in spec and "weights" not in spec:
        return x
    x = x.double()
    if "weights" in spec:
        w = torch.as_tensor(get(model, spec["weights"]["of"]),
                            dtype=torch.float64, device=x.device)
        dim = int(spec["weights"]["dim"])
        x = x * w.reshape((-1,) + (1,) * (x.dim() - dim - 1))
    return x.sum(dim=tuple(spec.get("sum", ())))


def gap(prog: torch.Tensor, ref: torch.Tensor, scale_of: str) -> float:
    p = prog.to(ref.device).double()
    r = ref.double()
    g = float(((p - r).abs() / _scale(r, scale_of).clamp(
        min=SCALE_FLOOR)).max())
    return g if g == g and g != float("inf") else float("inf")


def _scale(r: torch.Tensor, scale_of: str) -> torch.Tensor:
    if scale_of == "row":       # [B, rows, n]: per row, columns and levels
        return r.abs().amax(dim=(0, 2), keepdim=True)
    return r.abs().reshape(r.shape[0], -1).amax(1).reshape(   # per column
        (-1,) + (1,) * (r.dim() - 1))


def field_gaps(prog_state, ref_state, specs: dict, model=None) -> dict:
    """{name: gap} of a configuration's ``compare`` entries; ``model`` is
    the reference's, whose grid gives the weights."""
    return {k: gap(quantity(prog_state, s, model),
                   quantity(ref_state, s, model), s["scale"])
            for k, s in specs.items()}


def where(prog_state, ref_state, specs: dict, model=None) -> dict:
    """Where each widest gap lies: {name: {index, program, reference,
    scale}} (the calibration's look at a reading)."""
    out = {}
    for k, s in specs.items():
        r = quantity(ref_state, s, model).double()
        p = quantity(prog_state, s, model).to(r.device).double()
        scale = _scale(r, s["scale"]).clamp(min=SCALE_FLOOR).expand_as(r)
        rel = torch.nan_to_num((p - r).abs() / scale, nan=float("inf"))
        i = int(rel.flatten().argmax())
        idx = [int(j) for j in torch.unravel_index(torch.tensor(i),
                                                   r.shape)]
        out[k] = {"index": idx, "program": float(p.flatten()[i]),
                  "reference": float(r.flatten()[i]),
                  "scale": float(scale.flatten()[i])}
    return out


def flag_flips(prog_state, ref_state) -> dict:
    """{path: entries that differ} of every boolean field of the two
    states (the look at a reading: a threshold that flipped)."""
    out = {}
    for path, r in _leaves(ref_state):
        if r.dtype == torch.bool:
            out[path] = int((get(prog_state, path).to(r.device) != r).sum())
    return out


def init_gap(prog_state, ref_state, row_fields=()) -> float:
    """Widest gap over every floating field of the two starts; the fields
    in row_fields are scaled per row (species, J slot)."""
    worst = 0.0
    for path, r in _leaves(ref_state):
        if r.is_floating_point():
            p = get(prog_state, path)
            worst = max(worst, gap(p, r, "row" if path in row_fields
                                   else "column"))
    return worst


def _leaves(state, prefix=""):
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def to_reference(state, ref_state_module):
    """The program's state as the reference's dataclasses (the same
    fields and names; the tensors are shared, not copied)."""
    kw = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        kw[f.name] = (to_reference(v, ref_state_module)
                      if dataclasses.is_dataclass(v) else v)
    return getattr(ref_state_module, type(state).__name__)(**kw)


@contextlib.contextmanager
def tf32():
    """While open, float32 matrix products on the card run in TF32 (the
    second control: the radiation's and the gas solve's contractions)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_state(state, dtype):
    """state with every float32 field rounded to dtype."""
    return state.map(lambda x: x.to(dtype).to(x.dtype)
                     if x.dtype == torch.float32 else x)


def control_minute(model, state, round_to=None):
    """model's minute from state; with ``round_to`` (a torch dtype's
    name) the state is held in that precision between the steps: rounded
    before the clock step, before each substep and before the minute's
    radiation and photolysis (the model's own ``minute_step``, its steps
    wrapped on the instance)."""
    if round_to is None:
        return model.minute_step(state)
    dtype = getattr(torch, round_to)
    steps = ("pre_minute", "substep", "post_minute")
    for name in steps:
        setattr(model, name, lambda s, *a, fn=getattr(model, name):
                fn(round_state(s, dtype), *a))
    try:
        return model.minute_step(state)
    finally:
        for name in steps:
            delattr(model, name)
