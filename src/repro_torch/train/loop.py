"""The training loop: microbatching, checkpointing, straggler + preemption.

Port of :mod:`repro.train.loop`. One loop serves every arch family — the
per-arch pieces (loss_fn, pipeline) come from the caller. Fault-tolerance
behaviors:

* periodic async checkpoint (params + opt state + pipeline cursor),
* preemption-signal checkpoint at the next step boundary (blocking),
* straggler detection via a rolling-median heartbeat (host-side; logged
  into the metrics),
* deterministic resume: the pipeline cursor is restored and the data
  order replays exactly.

Each step's metrics become Python floats, which waits for the device (as
the reference's ``float(v)`` does), so the heartbeat sees the real step
time. The train step updates the state in place, so the loop copies the
caller's initial parameters once and never writes into them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.distributed import fault_tolerance as ft
from repro_torch.train import checkpoint as ckpt_mod, optimizer as opt_mod
from repro_torch.train import train_state as ts


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 100
    ckpt_dir: str | None = None
    log_every: int = 10
    microbatch: int = 0
    grad_clip: float = 1.0
    straggler_factor: float = 3.0
    install_signal_handlers: bool = False


@dataclasses.dataclass
class LoopResult:
    state: ts.TrainState
    history: list[dict]
    straggler_events: list[ft.StragglerEvent]
    preempted: bool
    resumed_from: int | None


def run(
    loss_fn: Callable,
    init_params,
    optimizer: opt_mod.Optimizer,
    next_batch: Callable[[], dict],
    cfg: LoopConfig,
    *,
    pipeline_state: Callable[[], dict] | None = None,
    restore_pipeline: Callable[[dict], None] | None = None,
    step_fn_transform: Callable | None = None,
) -> LoopResult:
    """Generic fault-tolerant training loop. ``step_fn_transform`` wraps
    the train step (default: the identity)."""
    step_fn = ts.make_train_step(
        loss_fn, optimizer, grad_clip=cfg.grad_clip, microbatch=cfg.microbatch
    )
    if step_fn_transform is not None:
        step_fn = step_fn_transform(step_fn)

    # one-time copy: the train step updates its state in place, which would
    # otherwise write into the caller's init_params
    init_params = opt_mod.tree_map(lambda x: x.detach().clone(), init_params)
    state = ts.TrainState.create(init_params, optimizer)
    manager = ckpt_mod.CheckpointManager(cfg.ckpt_dir) if cfg.ckpt_dir else None
    resumed_from = None
    if manager is not None and manager.latest_step() is not None:
        state, manifest = manager.restore(state)
        resumed_from = manifest["step"]
        if restore_pipeline is not None and "pipeline" in manifest["extra"]:
            restore_pipeline(manifest["extra"]["pipeline"])

    guard = ft.PreemptionGuard(install=cfg.install_signal_handlers)
    heartbeat = ft.Heartbeat(straggler_factor=cfg.straggler_factor)
    history: list[dict] = []
    start = int(state.step)

    def _save(step: int, blocking: bool = False) -> None:
        if manager is None:
            return
        extra = {}
        if pipeline_state is not None:
            extra["pipeline"] = pipeline_state()
        manager.save(step, state, extra=extra, blocking=blocking)

    preempted = False
    for step in range(start, cfg.total_steps):
        heartbeat.start_step(step)
        batch = next_batch()
        state, metrics = step_fn(state, batch)
        # materialize (waits for the device; heartbeat sees real step time)
        metrics = {k: float(v) for k, v in metrics.items()}
        ev = heartbeat.end_step()
        if ev is not None:
            metrics["straggler"] = 1.0
        if step % cfg.log_every == 0 or step == cfg.total_steps - 1:
            history.append({"step": step, **metrics})
        if cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0:
            _save(step + 1)
        if guard.requested:
            _save(step + 1, blocking=True)
            preempted = True
            break

    if manager is not None:
        _save(int(state.step), blocking=True)
        manager.wait()
    guard.restore()
    return LoopResult(
        state=state, history=history,
        straggler_events=heartbeat.events,
        preempted=preempted, resumed_from=resumed_from,
    )
