"""Column ensembles over cards and processes (counterpart of
``mistra_tpu.parallel.mesh``).

Columns are physically independent in this model family, so the
ensemble axis ("dp") is the first parallel axis.  The second ("tp")
splits ff's dry-aerosol axis: the JAX package shards ``micro.ff``'s nka
axis over the mesh's "tp" devices and lets XLA insert the reductions over
the bins.  The port does the same with one process per rank and
``torch.distributed``:

* ``init_distributed`` joins this process to the run's process group
  (the backend is named by the caller: ``nccl`` with one card per rank,
  ``gloo`` where ranks share a card or run on the CPU);
* ``make_mesh`` factors the ranks into (dp, tp) and gives this rank its
  ``Mesh``: its dp and tp indices, its tp group and its device;
* ``shard_state`` cuts a global state to this rank's share: its columns,
  and for the fields of ``state.BIN_FIELDS`` (ff and the per-bin
  deposition velocities vd) its dry bins; every other field is
  replicated over the tp ranks.  ``gather_state`` joins the shares again;
* ``make_ensemble_step`` steps this rank's share with a ``Model`` built
  with ``bins=mesh.bins(nka)``: every sum over the dry bins inside the
  step is that rank's partial sum completed by one all_reduce over its tp
  group (``parallel.bins``), and the replicated fields stay bit-equal
  across the tp ranks.

In one process (no process group, or a group of one) tp is 1 and
``make_mesh`` gives a list of devices: ``make_ensemble_step`` then splits
the batch of columns into one slice per device and steps each slice with
a ``Model`` replica on its device, one after another from this thread.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch

from ..state import BIN_FIELDS, join_states, repeat_columns
from .bins import BinShard

# the collectives' timeout: a rank that waits longer on another (one that
# failed, or left the step early) raises instead of waiting for ever
TIMEOUT_S = 300.0
BACKENDS = ("nccl", "gloo")

TP_NEEDS_RANKS = ("tp > 1 splits ff's dry-aerosol axis over ranks, one "
                  "process each: call init_distributed in every rank first")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     timeout_s: float = TIMEOUT_S) -> bool:
    """Join this process, rank ``process_id`` of ``num_processes``, to the
    process group at ``coordinator`` (``host:port``, ``tcp://host:port``
    or ``file:///path``) over ``backend``: ``"nccl"`` with one card per
    rank (this rank takes card process_id % cards), ``"gloo"`` where
    ranks share a card or run on the CPU.  Collectives that wait longer
    than ``timeout_s`` raise.  Returns True; a single process is a no-op
    and returns False.  Joining again with the same world is a no-op."""
    import torch.distributed as dist
    if num_processes in (None, 1):
        return False
    if backend not in BACKENDS:
        raise ValueError(f"name the backend, one of {BACKENDS}: nccl with "
                         f"one card per rank, gloo where ranks share a card "
                         f"or run on the CPU (got {backend!r})")
    if coordinator is None or process_id is None:
        raise ValueError("several processes need the coordinator's address "
                         "and this process's id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process {process_id} outside 0..{num_processes-1}")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                        process_id):
            raise RuntimeError(
                f"already rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, asked for {process_id} of "
                f"{num_processes}")
        return True
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("nccl needs a CUDA device in every rank")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=coordinator, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a ("dp", "tp") grid of ranks (rank = dp_index
    * tp + tp_index, as the JAX mesh's devices reshape to (dp, tp)).  dp
    counts every column shard, over every host of a host mesh.  The tp
    group is None where no process group exists (a mesh used only to cut
    or join states); ``shard_state`` moves the shares to ``device``, or
    leaves each on its own device where it is None."""
    dp: int
    tp: int
    rank: int = 0
    device: torch.device | None = None
    tp_group: object = None

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    def bins(self, nka: int) -> BinShard:
        """This rank's dry bins of an axis of nka (tp must divide it), for
        ``Model(..., bins=mesh.bins(nka))``."""
        return BinShard.split(nka, self.tp, self.tp_index, self.tp_group)


def _world() -> tuple:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _process_mesh(tp, devices) -> Mesh:
    """This rank's Mesh over the process group, its tp group from a
    ("dp", "tp") DeviceMesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world, rank = _world()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices (one per rank)")
        count = torch.cuda.device_count()
        devices = [f"cuda:{r % count}" for r in range(world)]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    # the groups' backend is the process group's: a "cuda" DeviceMesh
    # only where each rank has its own card (nccl)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(kind, (world // tp, tp),
                          mesh_dim_names=("dp", "tp"))
    return Mesh(dp=world // tp, tp=tp, rank=rank,
                device=torch.device(devices[rank]),
                tp_group=dm.get_group("tp"))


def make_mesh(n_devices: int | None = None, tp: int = 1, devices=None):
    """The mesh of this run.

    Several processes (``init_distributed`` called in each): this rank's
    ``Mesh`` of the world's ranks factored into (dp, tp); n_devices, if
    given, is the world size; devices lists each rank's device (by
    default rank r takes card r % cards).  One process: the devices of
    the ensemble axis, ``devices`` or every CUDA device (the first
    n_devices of them); tp must be 1."""
    world, _ = _world()
    if world > 1:
        if n_devices not in (None, world):
            raise ValueError(f"{n_devices} devices requested, the process "
                             f"group has {world} ranks")
        if tp < 1 or world % tp != 0:
            raise ValueError(f"{world} ranks not divisible by tp={tp}")
        return _process_mesh(tp, devices)
    if tp != 1:
        raise ValueError(TP_NEEDS_RANKS)
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} available")
    return [torch.device(d) for d in devices[:n_devices]]


def make_host_mesh(tp: int = 1, ranks_per_host: int | None = None,
                   devices=None) -> Mesh:
    """This rank's Mesh on a ("hosts", "dp", "tp") grid: ranks_per_host
    consecutive ranks per host (all by default), the columns over hosts
    and dp together, the dry bins over tp inside a host.  The ranks of a
    host are consecutive and tp divides ranks_per_host, so this is the
    (dp, tp) mesh of ``make_mesh`` with dp = hosts * ranks_per_host / tp:
    its tp groups never span two hosts.  One process is a mesh of one
    rank."""
    world, _ = _world()
    per_host = world if ranks_per_host is None else ranks_per_host
    if per_host < 1 or world % per_host != 0:
        raise ValueError(f"{world} ranks not divisible into hosts of "
                         f"{per_host}")
    if tp < 1 or per_host % tp != 0:
        raise ValueError(f"{per_host} ranks per host not divisible by "
                         f"tp={tp}")
    if world == 1:
        return Mesh(dp=1, tp=1,
                    device=torch.device(devices[0]) if devices else None)
    return make_mesh(tp=tp, devices=devices)


def replicate_state(state, batch: int):
    """Tile a one-column state into a [batch, ...] ensemble."""
    return repeat_columns(state, batch)


def spec_for(path: str, leaf) -> tuple:
    """Sharding rule of a field (its path as ``io.checkpoint.flatten_state``
    names it): the column axis over dp; the dry-aerosol axis of the
    fields of ``state.BIN_FIELDS`` (ff, vd) over tp; replicated over tp
    otherwise.  In the JAX package's ``PartitionSpec`` notation."""
    spec = ["dp"] + [None] * (leaf.dim() - 1)
    if path in BIN_FIELDS:
        spec[BIN_FIELDS[path]] = "tp"
    return tuple(spec)


def host_spec_for(path: str, leaf) -> tuple:
    """Sharding rule on a host mesh: the column axis over hosts and dp
    together, the dry-aerosol axis as ``spec_for``."""
    return (("hosts", "dp"),) + spec_for(path, leaf)[1:]


def shard_state(state, mesh: Mesh):
    """This rank's share of a global [B, ...] state (as ``spec_for``
    says), on the mesh's device."""
    def cut(path, x):
        spec = spec_for(path, x)
        B = x.shape[0]
        if B % mesh.dp != 0:
            raise ValueError(f"{B} columns not divisible by dp={mesh.dp}")
        per = B // mesh.dp
        x = x.narrow(0, mesh.dp_index * per, per)
        if "tp" in spec:
            x = mesh.bins(x.shape[spec.index("tp")]).take(
                x, spec.index("tp"))
        x = x.contiguous()
        return x if mesh.device is None else x.to(mesh.device)
    return state.map_paths(cut)


def shard_state_hosts(state, mesh: Mesh):
    """This rank's share of a global state on a host mesh
    (``make_host_mesh``): the same share as ``shard_state``'s, since the
    columns over (hosts, dp) in rank order are the columns over the host
    mesh's dp."""
    return shard_state(state, mesh)


def join_shards(shards, mesh: Mesh):
    """The global state of every rank's share (``shards`` in rank order,
    on one device).  Raises if a replicated field differs between the tp
    ranks of a column shard: they must hold it bit for bit."""
    tp = mesh.tp

    def join(path, xs):
        axis = BIN_FIELDS.get(path)
        parts = []
        for d in range(mesh.dp):
            own = xs[d * tp:(d + 1) * tp]
            if axis is not None:
                parts.append(torch.cat(own, dim=axis))
                continue
            for r, x in enumerate(own[1:], 1):
                if not torch.equal(x, own[0]):
                    raise ValueError(f"{path} differs between tp ranks 0 "
                                     f"and {r} of column shard {d}")
            parts.append(own[0])
        return torch.cat(parts, dim=0)
    return join_states(list(shards), join)


def gather_state(state, mesh: Mesh):
    """The global state on the CPU, in every rank, from each rank's share
    (copied through the host: gloo gathers no CUDA tensor)."""
    import torch.distributed as dist
    from ..io.checkpoint import flatten_state
    world, _ = _world()
    mine = state.to(torch.device("cpu"))
    if world == 1:
        return join_shards([mine], mesh)
    flats = [None] * world
    dist.all_gather_object(flats, flatten_state(mine))
    shards = [mine.map_paths(lambda path, _x, f=f: f[path]) for f in flats]
    return join_shards(shards, mesh)


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
    return join_states([s.to(device) for s in states],
                       lambda _path, xs: torch.cat(xs, dim=0))


def make_ensemble_step(model, mesh):
    """A minute step of a column ensemble.

    With a ``Mesh`` (several processes): ``model`` is this rank's
    ``Model`` (or ``BoxModel``), built with ``bins=mesh.bins(nka)`` on
    ``mesh.device`` and ready to step; the returned ``step(share)`` steps
    this rank's share (``shard_state``) of the ensemble.

    With a list of devices (one process): ``model`` is a factory,
    model_factory(device) returning a ready ``Model`` (or ``BoxModel``)
    on that device.  The returned ``step(state)`` splits the batch into
    one slice per device, runs each replica's ``minute_step`` and joins
    the columns again on the input state's device.  The replicas run one
    after another from this thread, and the minute waits on the host
    (the Ros3 loop syncs every iteration), so k devices take about k
    minutes' time: the split spreads an ensemble's memory over the cards,
    it does not make the minute faster than one batched card.
    """
    if isinstance(mesh, Mesh):
        want = mesh.bins(model.cfg.grid.nka)
        have = model.bins
        if (have.lo, have.hi, have.group) != (want.lo, want.hi, want.group):
            raise ValueError(
                f"the model steps bins [{have.lo}, {have.hi}), this rank of "
                f"the mesh holds [{want.lo}, {want.hi}): build it with "
                "bins=mesh.bins(nka)")

        def step(state):
            return model.minute_step(state)

        step.models = [model]
        return step

    devices = [torch.device(d) for d in mesh]
    models = [model(d) for d in devices]

    def step(state):
        home = state.met.t.device
        parts = split_columns(state, len(models))
        out = [m.minute_step(p.to(m.device))
               for m, p in zip(models, parts)]
        return join_columns(out, home)

    step.models = models
    return step
