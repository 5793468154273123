"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start to the window's):
import the port, load its kernels (``mistra_tpu_torch/_build/``, built
there by the first run of a checkout), write the stand-in tables and
mechanism into a directory under ``TMPDIR``, build ``Model(cfg,
device="cuda")``, start the ensemble (``traffic.start``) and run the mix's
warm-up minutes.  The window then runs whole ``minute_step`` calls, each
ended by ``torch.cuda.synchronize()``, until ``--seconds`` have passed.

``column_min_per_s`` is the columns times the whole minutes of the window
over the window's wall time; where the configuration sets
``end_lmin_multiple``, the window ends on such a minute (``run_cell``).
``--trace 1`` runs the same with the spans and counters that the cell's
per-layer readers declare (``trace.instrument``) and profiles the mix's
slice; its metrics are the cell's per-layer ones.  After the window the
reference (``compare``) decides ``correct``; each compared number is
printed beside its limit, last on standard error and last in the result
line.

Without a CUDA card, or with fewer than the cell asks for, the run fails
and prints no result; so it does where ``mistra_tpu_torch`` is absent, or
where a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time


def _process_start() -> float:
    """Wall-clock time at which this process started (/proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - started / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


import torch

from . import compare, registry, trace, traffic
from .standins import write_inputs

# top-level module names the run must not have loaded (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "mistra_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unreadable"


def build_config(pkg, spec: dict, inpdir: str, mechdir: str,
                 settings: dict | None = None):
    """pkg.MistraConfig (the program's or the reference's) of a
    configuration file, its settings updated by ``settings``."""
    return pkg.MistraConfig(grid=pkg.GridParams(**spec["grid"]),
                            inpdir=inpdir, mechdir=mechdir,
                            **dict(spec["settings"], **(settings or {})))


def model_class(pkg: str, spec: dict):
    """The class that the configuration's ``model`` (``"<module>:<class>"``)
    names in the package pkg (the program's or the reference's)."""
    module, name = spec["model"].split(":")
    return getattr(importlib.import_module(f"{pkg}.{module}"), name)


def _sync(cuda: bool):
    if cuda:
        torch.cuda.synchronize()


def _bad_columns(prev, state):
    """[B] bool: columns with a non-finite compared field, or (with
    chemistry) a Ros3 cell that ran out of steps, in this minute."""
    fields = [state.met.t, state.met.xm1, state.micro.ff, state.rad.dtrad]
    if state.chem is not None:
        fields.append(state.chem.conc)
    ok = torch.stack([torch.isfinite(x).flatten(1).all(1) for x in fields])
    bad = ~ok.all(0)
    if state.chem is not None:
        bad = bad | (state.chem.nonconv > prev.chem.nonconv)
    return bad


class _GcClock:
    """Seconds and count of the garbage collector's passes while open
    (gc.callbacks): printed beside the minutes, to tell the collector's
    pauses from the host's noise."""

    def __init__(self):
        self.seconds, self.passes, self._t = 0.0, 0, None

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.passes += 1

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             device: str = "cuda", root=registry.ROOT, controls=(),
             per_layer: list = (), started: float | None = None,
             diagnose: bool = False) -> dict:
    """One run of a cell: set-up, the window, the reference's check.

    Returns the result's parts: ``attempted``, ``failed``, ``e2e`` (the
    end-to-end readings), ``per_layer`` (readings of the metrics named in
    per_layer, traced runs only), ``device``, ``breakdown``, ``gaps``
    (every compared number) and ``controls``: for each name in controls
    (of the configuration's ``controls``), the same numbers of that
    control against the reference.  With ``diagnose``, ``where`` says
    where each widest gap lies and ``flips`` counts the boolean entries
    in which the two states differ.  ``root`` holds the configuration
    and traffic files (the tests' small ones live elsewhere).
    ``setup_s`` runs from ``started`` (wall clock; the process's start by
    default).

    The window runs whole minutes until ``seconds`` have passed and, where
    the configuration sets ``end_lmin_multiple``, on until the model's
    minute (``tim.lmin``) is a multiple of it: photolysis recomputes its
    rates on even minutes only, so the compared minute is one that does.
    """
    started = _process_start() if started is None else started
    import mistra_tpu_torch as prog
    from . import reference as ref
    from .reference import state as ref_state

    cuda = device == "cuda"
    spec = registry.config(cell["config"], root)
    mix = registry.traffic(cell["traffic"], root)
    readers = [registry.metric_reader(m["name"], root) for m in per_layer]
    tmp = tempfile.TemporaryDirectory(prefix="portbench-")
    try:
        inpdir, mechdir = write_inputs(spec["inputs"], tmp.name)
        if cuda:
            from mistra_tpu_torch.kernels.build import load_library
            load_library()
        model = model_class("mistra_tpu_torch", spec)(
            build_config(prog, spec, inpdir, mechdir), device=device)
        state = traffic.start(model, seed, spec, mix)
        start = state.map(torch.clone)
        for _ in range(int(mix["warmup_minutes"])):
            state = model.minute_step(state)
        _sync(cuda)

        spans = trace.Spans(cuda)
        profile = trace.Profile(spans)
        handle = None
        slice_kind, slice_len = next(iter(mix["profile"].items()))
        if traced:
            handle = trace.instrument(model, spans, profile, readers)
            if cuda and slice_kind == "substeps":
                _profile_substeps(model, profile, int(slice_len))
            if cuda and slice_kind == "minutes":
                profile.start()

        step = (spans.wrap("minute", model.minute_step) if traced
                else model.minute_step)
        end_every = int(spec.get("end_lmin_multiple", 1))
        setup_s = time.time() - started
        flags, minute_starts = [], []
        with _GcClock() as gc_clock:
            t0 = time.perf_counter()
            while True:
                minute_starts.append(time.perf_counter())
                prev = state
                state = step(state)
                flags.append(_bad_columns(prev, state))
                _sync(cuda)
                if (traced and profile.open and slice_kind == "minutes"
                        and len(minute_starts) == int(slice_len)):
                    profile.stop()
                if (time.perf_counter() - t0 >= seconds
                        and int(state.tim.lmin[0]) % end_every == 0):
                    break
            window_s = time.perf_counter() - t0
        if profile.open:
            profile.stop()

        B, minutes = int(mix["columns"]), len(minute_starts)
        out = {"attempted": B * minutes,
               "failed": int(torch.stack(flags).sum()),
               "e2e": {"column_min_per_s": B * minutes / window_s,
                       "setup_s": setup_s},
               "minutes": minutes, "window_s": window_s,
               "minute_s": [b - a for a, b in zip(
                   minute_starts, minute_starts[1:] + [t0 + window_s])],
               "gc": {"seconds": gc_clock.seconds,
                      "passes": gc_clock.passes},
               "device": _device(cuda)}
        if traced:
            data = trace.collect(handle, spans)
            trace.undo(handle)
            out.update(_traced(spans, profile, data, minutes, per_layer,
                               readers))
        del model, flags
        if cuda:
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        if cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        ref_model = model_class("portbench.reference", spec)
        rmodel = ref_model(build_config(ref, spec, inpdir, mechdir),
                           device=device)
        compared = spec["compare"]
        rows = {s["field"] for s in compared.values() if s["scale"] == "row"}
        rstart = traffic.start(rmodel, seed, spec, mix)
        gaps = {"init": compare.init_gap(start, rstart, rows)}
        del start
        rprev = compare.to_reference(prev, ref_state)
        rnext = rmodel.minute_step(rprev)
        gaps.update(compare.field_gaps(state, rnext, compared, rmodel))
        if diagnose:
            out["where"] = compare.where(state, rnext, compared, rmodel)
            out["flips"] = compare.flag_flips(state, rnext)
        out["controls"] = {}
        for name in controls:
            c = spec["controls"][name]
            cmodel = (ref_model(build_config(ref, spec, inpdir, mechdir,
                                             c["settings"]), device=device)
                      if "settings" in c else rmodel)
            with (compare.tf32() if c.get("tf32")
                  else contextlib.nullcontext()):
                cstart = (rstart if cmodel is rmodel and not c.get("tf32")
                          else traffic.start(cmodel, seed, spec, mix))
                if "round_state" in c:
                    cstart = compare.round_state(
                        cstart, getattr(torch, c["round_state"]))
                cnext = compare.control_minute(cmodel, rprev,
                                               c.get("round_state"))
            out["controls"][name] = dict(
                init=compare.init_gap(cstart, rstart, rows),
                **compare.field_gaps(cnext, rnext, compared, rmodel))
            del cmodel, cstart, cnext
        _sync(cuda)
        out["gaps"] = gaps
        out["reference_s"] = time.perf_counter() - t_ref
        return out
    finally:
        tmp.cleanup()


def _device(cuda: bool) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": torch.cuda.max_memory_allocated()}


def _profile_substeps(model, profile, count: int):
    """Profile the window's first ``count`` substeps: wrap model.substep
    (an instance attribute, which minute_step calls) to open the slice
    before the first and close it after the last."""
    substep = model.substep
    seen = [0]

    def sliced(state, dd):
        if seen[0] == 0:
            profile.start()
        out = substep(state, dd)
        seen[0] += 1
        if seen[0] == count:
            profile.stop()
        return out
    model.substep = sliced


def _traced(spans, profile, data, minutes, per_layer, readers) -> dict:
    """The per-layer readings and breakdown of a traced run."""
    summary = profile.summary() if profile.done else None
    data = dict(data, minutes=minutes, substeps=data["span_calls"].get(
        "substep", 0), span_ms=spans.synced_ms(), profile=summary)
    readings = {}
    for m, reader in zip(per_layer, readers):
        value = reader.read(data)
        if value is not None:
            readings[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"per_layer": readings}
    if summary is not None:
        top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1])
        gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = {"device_ops": [[k, v] for k, v in top[:10]],
                            "idle_gaps": [[k, v] for k, v in gaps[:10]]}
        out["device_trace"] = {"busy_s": summary["busy_s"],
                               "window_s": summary["wall_s"],
                               "events": summary["events"]}
    return out


def judge(gaps: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every gap within its
    limit (a number without a limit fails)."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in gaps.items()}
    return all(c["limit"] is not None and c["value"] <= c["limit"]
               for c in checks.values()), checks


def result(bench: dict, workload: str, out: dict, traced: bool,
           card: str) -> dict:
    """The result line of a run: correct, attempted, failed, the
    metrics (the cell's end-to-end ones, or with ``traced`` its per-layer
    ones), device, breakdown, the card, and last the compared numbers
    beside their limits."""
    cell = registry.cell(bench, workload)
    spec = registry.config(cell["config"])
    correct, checks = judge(out["gaps"], spec["limits"])
    device = out["device"]
    if traced:
        metrics = out["per_layer"]
        trace_device = out.get("device_trace", {})
        device = dict(device, busy_s=trace_device.get("busy_s"),
                      window_s=trace_device.get("window_s"))
    else:
        units = {m["name"]: m["unit"]
                 for m in registry.end_to_end(bench, workload)}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out["e2e"].items()}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["card"] = card
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        print(f"portbench: the cell {args.workload} needs {cell['chips']} "
              f"CUDA card(s), this host has {have}; no result",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"portbench: {args.workload} seed {args.seed}, {card}",
          file=sys.stderr)
    per_layer = registry.per_layer(bench, args.workload) if args.trace else []
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   per_layer=per_layer)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    line = result(bench, args.workload, out, bool(args.trace), card)
    print(f"portbench: {out['minutes']} minutes in {out['window_s']:.3f} s, "
          f"set-up {out['e2e']['setup_s']:.3f} s, reference "
          f"{out['reference_s']:.3f} s, {out['failed']} failed of "
          f"{out['attempted']} column-minutes; gc {out['gc']['passes']} "
          f"passes, {out['gc']['seconds']:.3f} s in the window; minutes of "
          f"{' '.join(f'{t:.3f}' for t in out['minute_s'])} s",
          file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
