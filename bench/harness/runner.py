"""One run of one cell: set-up, the measured window, the check against
the reference, the metrics, and the result line.

The loop that drives the program is chosen by the traffic mix's
``kind`` (``bench/loops/<kind>.py``), the engine by the configuration's
``engine`` (``bench/engines/<engine>.py``), and every metric is read by
its own file (``bench/metrics/<name>.py``).

A loop module defines ``Loop(ctx)``, which sets the program up, with
``warm()``, ``window(seconds, trace) -> outcome`` (``window_s``,
``attempted``, ``failed`` and what its metrics read), ``release()``
(frees the program's state, keeping the outputs to judge), ``check() ->
{name: (value, limit)}``, ``work() -> {name: callable}`` (yardstick
quantities) and the lists ``program_spans`` and ``host_spans``
(``(name, t0_ns, t1_ns)``, filled in traced windows); and
``control_patches(cell, seed, device)``, the attributes that put the
control in the program's place (``bench/control.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import sys
import time

import torch

from harness import data, observe, spec
from harness.devtrace import DeviceTrace
from harness.record import Record

# top-level module names that must not be loaded: the JAX package and JAX
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Ctx:
    """What a loop gets: the cell's files, its inputs, its device."""

    cell: spec.Cell
    seed: int
    seconds: float            # the measured window's length
    device: torch.device
    engine: object            # the engine's module
    genomes: list             # the archive, file i = genomes[i]

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def built_index(self):
        """A fresh index with the whole archive in it, as a deployment
        boots one."""
        build = self.config["build"]
        index = self.engine.new_index(self.config, self.device)
        return self.engine.build(index, self.genomes, build["window_bases"],
                                 build["chunk_reads"])


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_process: float) -> dict:
    """Run ``cell`` once and return its result line (a dict)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    engine = importlib.import_module(f"engines.{cell.config['engine']}")
    ctx = Ctx(cell=cell, seed=seed, seconds=seconds, device=device,
              engine=engine, genomes=data.archive(cell.config, seed))
    kind = importlib.import_module(f"loops.{cell.mix['kind']}")
    loop = kind.Loop(ctx)
    loop.warm()
    ctx.sync()
    setup_s = time.monotonic() - t_process

    before = observe.snapshot()
    devtrace = DeviceTrace() if trace and cuda else None
    if devtrace is not None:
        with devtrace:
            outcome = loop.window(seconds, trace)
    else:
        outcome = loop.window(seconds, trace)
    obs = observe.delta(before, observe.snapshot())
    if devtrace is not None:
        print(f"trace clock: offset {devtrace.clock_offset_ns} ns, drift "
              f"{devtrace.clock_drift_ns} ns over the window",
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    loaded = forbidden_loaded()
    if loaded:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: "
                           f"{loaded}")

    loop.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = loop.check()

    rec = Record(setup_s=setup_s, window_s=outcome["window_s"],
                 peak_bytes=peak, outcome=outcome, obs=obs,
                 spans=loop.program_spans, device=devtrace,
                 work=loop.work())
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.load_reader(m["name"])(rec)
        if value is None:
            if cuda and not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} has no "
                                   f"reading in this run")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    line = {"correct": all(v <= lim for v, lim in checks.values()),
            "attempted": int(outcome["attempted"]),
            "failed": int(outcome["failed"]),
            "metrics": metrics,
            "device": device_info(device, peak, devtrace)}
    if devtrace is not None:
        line["breakdown"] = {
            "device_ops": devtrace.top_ops(),
            "idle_gaps": devtrace.idle_gaps(loop.host_spans
                                            + loop.program_spans)}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, (v, lim) in checks.items()}
    return line


def device_info(device: torch.device, peak: int, devtrace) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": int(peak)}
    if devtrace is not None:
        out["busy_s"] = devtrace.busy_s
        out["window_s"] = devtrace.window_s
    return out
