"""Column ensembles over the cards of one host (counterpart of
``mistra_tpu.parallel.mesh``).

Columns are physically independent in this model family, so the
ensemble axis ("dp") is the parallel axis: ``make_ensemble_step`` splits
the batch of columns into one slice per device, steps each slice with a
``Model`` replica on its device and joins the columns again.  No
collective is needed.

The JAX package also shards ff's dry-aerosol axis over a second mesh axis
("tp"), where XLA inserts the reductions over the bins.  That needs
collectives inside the step and is not ported: ``tp`` must be 1 (ROADMAP
§1, queue 1: the tp > 1 split).
"""

from __future__ import annotations

import torch

from ..state import repeat_columns

TP_UNPORTED = ("tp > 1 (sharding ff's nka axis over devices) needs "
               "collectives inside the step and is not ported "
               "(ROADMAP §1, queue 1: the tp > 1 split); use tp=1")


def make_mesh(n_devices: int | None = None, tp: int = 1,
              devices=None) -> list:
    """The devices of the ensemble axis: ``devices`` or every CUDA device
    (the first n_devices of them).  tp > 1 raises."""
    if tp != 1:
        raise NotImplementedError(TP_UNPORTED)
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} available")
    return [torch.device(d) for d in devices[:n_devices]]


def replicate_state(state, batch: int):
    """Tile a one-column state into a [batch, ...] ensemble."""
    return repeat_columns(state, batch)


def split_columns(state, parts: int) -> list:
    """The state cut along its column axis into ``parts`` slices (as
    equal as they go)."""
    B = state.met.t.shape[0]
    if not 1 <= parts <= B:
        raise ValueError(f"cannot split {B} columns into {parts} slices")
    bounds = [B * i // parts for i in range(parts + 1)]
    return [state.map(lambda x, a=a, b=b: x[a:b])
            for a, b in zip(bounds[:-1], bounds[1:])]


def join_columns(states, device):
    """One state of the columns of ``states``, in order, on device."""
    def cat(objs):
        if objs[0] is None:
            return None
        if torch.is_tensor(objs[0]):
            return torch.cat(objs, dim=0)
        return type(objs[0])(**{f: cat([getattr(o, f) for o in objs])
                                for f in objs[0].__dataclass_fields__})
    return cat([s.to(device) for s in states])


def make_ensemble_step(model_factory, devices, tp: int = 1):
    """A minute step of a column ensemble over ``devices``.

    model_factory(device) returns a ``Model`` (or ``BoxModel``) on that
    device, ready to step (its ``init_state`` called, which installs the
    drivers).  The returned ``step(state)`` splits the batch into one
    slice per device, runs each replica's ``minute_step`` and joins the
    columns again on the input state's device.  The replicas run one
    after another from this thread, and the minute waits on the host
    (the Ros3 loop syncs every iteration), so k devices take about k
    minutes' time: the split spreads an ensemble's memory over the cards,
    it does not make the minute faster than one batched card.
    """
    if tp != 1:
        raise NotImplementedError(TP_UNPORTED)
    devices = [torch.device(d) for d in devices]
    models = [model_factory(d) for d in devices]

    def step(state):
        home = state.met.t.device
        parts = split_columns(state, len(models))
        out = [m.minute_step(p.to(m.device))
               for m, p in zip(models, parts)]
        return join_columns(out, home)

    step.models = models
    return step


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """A single process is a no-op and returns False.  A run over several
    processes would need the collectives of the tp > 1 split, so it
    raises."""
    if num_processes in (None, 1):
        return False
    raise NotImplementedError(
        "a run over several processes needs the collectives of the tp > 1 "
        "split (ROADMAP §1, queue 1), which are not ported")
