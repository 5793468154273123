# Frozen copy of mistra_tpu_torch/parallel/bins.py (lines 1-167, commit b2518445).
"""This rank's share of ff's dry-aerosol axis (the "tp" axis of the
ensemble mesh).

The JAX package shards ``micro.ff`` ``[B, nkt, nka, n]`` on its nka axis
over the mesh's "tp" devices and lets XLA insert the reductions over the
bins (``mistra_tpu.parallel.mesh._spec_for``).  The port runs one process
per rank: a ``BinShard`` says which bins ``[lo, hi)`` of the global axis
this rank holds and turns every sum over the nka axis into this rank's
partial sum followed by one ``all_reduce(SUM)`` over the tp group
(``sum_bins``).  Where a loop over the bins is sequential (konc's), the
rank takes the whole axis of small per-bin counts (``gather_bins``);
where a rank's bins send particles to bins of other ranks (the mass
feedback), each rank forms its contribution to the whole axis and
``reduce_home`` brings every bin's share to the rank that holds it.  A
``Model`` holds one; by default it is the whole axis,
where ``sum_bins`` returns its arguments and the step is the single-rank
step.

Per-bin constants are built from the global index and then cut with
``take``, so a rank's bins carry their global identity (radii, masses,
the chemistry bins' ``ia < ka`` test).  The fields split over "tp" are
listed in ``state.BIN_FIELDS``; every other field is replicated over the
tp ranks and, because every rank does the same replicated work on the
same reduced sums, stays bit-equal across them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..state import BIN_FIELDS


class BinShard:
    """Bins ``[lo, hi)`` of a dry-aerosol axis of ``nka`` bins and the tp
    process group that holds the others (None for the whole axis).

    ``calls``, ``seconds`` and ``bytes`` count the all_reduce calls of
    ``sum_bins``, ``gather_bins``, ``reduce_home`` and ``all_agree``, the
    host time they took (each waits for its result) and the bytes of the
    tensors they reduced."""

    def __init__(self, nka: int, lo: int = 0, hi: int | None = None,
                 group=None):
        hi = nka if hi is None else hi
        if not 0 <= lo < hi <= nka:
            raise ValueError(f"bins [{lo}, {hi}) outside [0, {nka})")
        self.nka, self.lo, self.hi, self.group = nka, lo, hi, group
        self.calls = 0
        self.seconds = 0.0
        self.bytes = 0

    @classmethod
    def split(cls, nka: int, tp: int, index: int, group=None) -> BinShard:
        """Part ``index`` of ``tp`` equal parts of the axis."""
        if tp < 1 or nka % tp != 0:
            raise ValueError(f"tp={tp} must divide nka={nka} (each tp rank "
                             f"holds nka/tp dry-aerosol bins)")
        if not 0 <= index < tp:
            raise ValueError(f"tp index {index} outside [0, {tp})")
        width = nka // tp
        return cls(nka, index * width, (index + 1) * width,
                   group if tp > 1 else None)

    @property
    def width(self) -> int:
        return self.hi - self.lo

    @property
    def is_whole(self) -> bool:
        return self.width == self.nka

    def covering(self, width: int) -> BinShard:
        """The shard of an array with ``width`` dry bins: this one, or the
        whole axis for a whole-axis array (the host column that
        ``Model.init_state`` builds before it shards it)."""
        if width == self.width:
            return self
        if width == self.nka:
            return BinShard(self.nka)
        raise ValueError(f"{width} dry bins are neither this rank's "
                         f"{self.width} nor the axis' {self.nka}")

    def take(self, x, dim: int):
        """x's slice of this rank's bins along dim (a tensor or a numpy
        array indexed by the global bin)."""
        if self.is_whole:
            return x
        if isinstance(x, np.ndarray):
            return np.take(x, np.arange(self.lo, self.hi), axis=dim)
        return x.narrow(dim, self.lo, self.width)

    def take_state(self, state):
        """state with each field of ``BIN_FIELDS`` cut to this rank's
        bins (the others as they are)."""
        if self.is_whole:
            return state
        return state.map_paths(
            lambda path, x: self.take(x, BIN_FIELDS[path]).contiguous()
            if path in BIN_FIELDS else x)

    def sum_bins(self, *partial):
        """The sums over every bin of the axis, given each tensor's sum
        over this rank's bins: one all_reduce over the tp group for all
        of them.  Returns one tensor, or a tuple for several."""
        if self.is_whole:
            return partial[0] if len(partial) == 1 else partial
        flat = self._all_reduce(torch.cat([p.reshape(-1) for p in partial]),
                                "SUM")
        out, at = [], 0
        for p in partial:
            out.append(flat[at:at + p.numel()].view(p.shape))
            at += p.numel()
        return out[0] if len(out) == 1 else tuple(out)

    def gather_bins(self, x, dim: int):
        """The whole axis of x along dim, given this rank's slice: the
        slice written into zeros of the whole axis, then one all_reduce
        (SUM) over the tp group.  Exact (every other rank adds zeros), so
        the result is bit-equal on every rank."""
        if self.is_whole:
            return x
        shape = list(x.shape)
        shape[dim] = self.nka
        whole = x.new_zeros(shape)
        whole.narrow(dim, self.lo, self.width).copy_(x)
        return self._all_reduce(whole, "SUM")

    def reduce_home(self, x, dim: int):
        """This rank's slice along dim of the sum over the tp ranks of
        x, each rank's contribution to the whole axis: one all_reduce
        (SUM) of the whole axis, in place where x is contiguous, then
        this rank's bins (gloo has no reduce_scatter; one code path
        serves both backends)."""
        if self.is_whole:
            return x
        return self.take(self._all_reduce(x.contiguous(), "SUM"), dim)

    def all_agree(self, flags):
        """flags (bool) true only where they are true on every tp rank:
        one all_reduce(MIN) over the tp group.  A loop that holds a
        collective stops on flags passed through here, so that every rank
        takes the same decision even where the replicated inputs of the
        flags differ between ranks in their last bit."""
        if self.is_whole:
            return flags
        return self._all_reduce(flags.to(torch.int32), "MIN").bool()

    def _all_reduce(self, flat, op: str):
        if self.group is None:
            raise RuntimeError(f"bins [{self.lo}, {self.hi}) of {self.nka} "
                               "have no tp group to reduce over")
        import torch.distributed as dist
        t0 = time.perf_counter()
        dist.all_reduce(flat, op=getattr(dist.ReduceOp, op), group=self.group)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes += flat.numel() * flat.element_size()
        return flat

    def reset_counts(self) -> None:
        self.calls = 0
        self.seconds = 0.0
        self.bytes = 0
