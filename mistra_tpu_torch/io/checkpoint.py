"""Checkpoint / restart of the full model state.

Torch counterpart of ``mistra_tpu.io.checkpoint``.  It replaces the
reference's unformatted restart records (``outm``/``outc`` writing
rstm.dat/rstc.dat, outp.f90:55-313; read back by ``startm``/``startc``,
str.f90:1914-2163) and keeps their restart-equivalence property: running
N minutes equals running N/2, checkpointing, restoring into a freshly
initialised model and running N/2 more, bit for bit.

The format is the port's own (the JAX package writes an orbax directory):
one ``torch.save`` file of a dict with the state's tensors on the CPU
keyed by field path (``"met.t"``, ``"chem.conc"``) and the chemistry
state's class name.  It is read with ``weights_only=True``.  A restore
takes the field set, shapes and dtypes from a template state (for
example the model's ``init_state()``) and refuses a checkpoint that
differs from it in any of them; it never casts.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..state import _Fields

FORMAT = "mistra_tpu_torch.state/1"


def flatten_state(state, prefix: str = "") -> dict:
    """{field path: tensor} of a state's dataclasses; a sub-state that is
    None (chem with chemistry off) has no entry."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        if isinstance(v, _Fields):
            out.update(flatten_state(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


def _chem_class(state):
    return None if state.chem is None else type(state.chem).__name__


def save_checkpoint(path: str, state) -> str:
    """Write the state to the file ``path`` (atomically: a partial write
    never replaces an earlier checkpoint); returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"format": FORMAT, "chem_class": _chem_class(state),
               "fields": {k: v.detach().cpu().clone()
                          for k, v in flatten_state(state).items()}}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _rebuild(template, fields, prefix=""):
    out = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        if v is None:
            out[f.name] = None
        elif isinstance(v, _Fields):
            out[f.name] = _rebuild(v, fields, f"{prefix}{f.name}.")
        else:
            out[f.name] = fields[prefix + f.name].to(v.device)
    return type(template)(**out)


def restore_checkpoint(path: str, template):
    """The state saved at ``path``, on the template's device.

    ``template`` gives the structure, shapes and dtypes (a state built by
    the same configuration); a checkpoint whose chemistry state class,
    field set, shapes or dtypes differ raises ``ValueError``.
    """
    payload = torch.load(os.path.abspath(path), weights_only=True,
                         map_location="cpu")
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a mistra_tpu_torch checkpoint")
    if payload["chem_class"] != _chem_class(template):
        raise ValueError(
            f"checkpoint {path} holds chemistry state "
            f"{payload['chem_class']}, the model runs "
            f"{_chem_class(template)}")
    saved = payload["fields"]
    want = flatten_state(template)
    if set(saved) != set(want):
        missing = sorted(set(want) - set(saved))
        extra = sorted(set(saved) - set(want))
        raise ValueError(f"checkpoint {path} does not match the model's "
                         f"state: missing {missing}, unexpected {extra}")
    for k, t in want.items():
        s = saved[k]
        if s.shape != t.shape or s.dtype != t.dtype:
            raise ValueError(
                f"checkpoint {path}: {k} is {s.dtype} {tuple(s.shape)}, "
                f"the model's state has {t.dtype} {tuple(t.shape)}")
    return _rebuild(template, saved)
