#!/usr/bin/env python3
"""Where the LM serving path's time goes, and how far its decode step drifts
from a fresh forward, on one CUDA card.

    PYTHONPATH=src python scripts/lm_serving_probe.py [--out DIR]

For ``granite-moe-1b-a400m`` (24 layers) and ``granite-20b`` (4 of its 52
layers), both at full width in bf16 with random weights from seed 0, the
shapes of ``chip_smoke.py`` phase 10 (an 8 x 512 prefill, decode at batch
8):

1. ``torch.profiler`` over one warm prefill and 4 warm decode steps: the
   wall time, the device's busy time (the profiler's "Self CUDA time
   total"), the kernel launches, and (with ``--out``) the op tables;
2. prefill of 64 tokens + one decode step against ``lm_forward`` on the
   65 tokens (MoE capacity 16), in bf16 and in f32 of the same weights on
   the card, and for the MoE arch in bf16 on the CPU too: the largest
   logit gap, the logits outside rtol/atol 0.05, and the (row, layer)
   routings of the last token that differ between the two paths.

It exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import lm_common  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ARCHS = ((chip_smoke.LM_MOE, None),
         (chip_smoke.LM_DENSE, chip_smoke.LM_DENSE_LAYERS))
BATCH, SEQ, STEPS = chip_smoke.LM_BATCH, chip_smoke.LM_SEQ, 4
CHECK = chip_smoke.LM_CHECK_SEQ
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchKernelExC")


def profiled(fn, tables, label: str) -> str:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key in LAUNCHES)
    table = ev.table(sort_by="self_device_time_total", row_limit=15,
                     max_name_column_width=60)
    tables.append(f"== {label}\n" + table + ev.table(
        sort_by="self_cpu_time_total", row_limit=15,
        max_name_column_width=60))
    # the profiler's own total of kernel time, from its table's footer
    busy = re.search(r"Self CUDA time total: ([0-9.]+)(us|ms|s)", table)
    busy_ms = (float(busy.group(1)) * {"us": 1e-3, "ms": 1.0, "s": 1e3}[
        busy.group(2)]) if busy else float("nan")
    return (f"{label}: wall {wall * 1e3:.3f} ms (profiled), device busy "
            f"{busy_ms:.3f} ms ({busy_ms / (wall * 1e3):.1%}), kernel "
            f"launches {launches}")


def gap(params, cfg, toks) -> dict:
    step, fwd, flips = chip_smoke.prefill_decode_vs_forward(params, cfg, toks)
    out = {"max_abs_err": float((step - fwd).abs().max()),
           "outside_0.05": int((~torch.isclose(step, fwd, rtol=0.05,
                                                atol=0.05)).sum())}
    if cfg.moe is not None:
        out["routing_flips"] = flips
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for the profiler's op tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lm_serving_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi())
    tables: list = []
    for arch, n_layers in ARCHS:
        spec = configs.get(arch)
        cfg = spec.make_config()
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        model = tf.lm_init(0, cfg, dtype=lm_common.param_dtype(cfg),
                           device=dev)
        params = model.params()
        cell = dataclasses.replace(
            spec.shapes["prefill_32k"],
            meta={"seq": SEQ, "batch": BATCH, "mode": "prefill"})
        prefill = spec.step_fn(cfg, cell)
        decode = spec.step_fn(cfg, spec.shapes["decode_32k"])
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (BATCH, SEQ))).to(dev)
        logits, cache = prefill(params, {"tokens": toks})
        state = {"params": params,
                 "cache": model.init_kv_cache(BATCH, SEQ + 1 + STEPS)}
        with torch.inference_mode():
            state["cache"]["k"][:, :, :SEQ] = cache["k"]
            state["cache"]["v"][:, :, :SEQ] = cache["v"]
            state["cache"]["len"] = cache["len"]
        del cache
        nxt = logits.argmax(-1)

        def steps(n):
            for _ in range(n):
                state["cache"] = decode(state, {"tokens": nxt})["cache"]

        steps(1)                                   # warm
        torch.cuda.synchronize()
        print(profiled(lambda: prefill(params, {"tokens": toks}), tables,
                       f"{arch} prefill {BATCH}x{SEQ}"))
        print(profiled(lambda: steps(STEPS), tables,
                       f"{arch} {STEPS} decode steps at batch {BATCH}"))
        del state, logits
        ccfg = cfg if cfg.moe is None else dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
        ctoks = toks[:, :CHECK + 1]
        print(f"{arch} prefill {CHECK} + 1 decode step vs lm_forward, bf16 "
              f"on the card: {gap(params, ccfg, ctoks)}")
        f32 = chip_smoke.tree_map(lambda p: p.float(), params)
        print(f"{arch} the same in f32 on the card: "
              f"{gap(f32, ccfg, ctoks)}")
        del f32
        if cfg.moe is not None:
            cpu = chip_smoke.tree_map(lambda p: p.cpu(), params)
            print(f"{arch} the same in bf16 on the CPU: "
                  f"{gap(cpu, ccfg, ctoks.cpu())}")
            del cpu
        del model, params
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "lm_serving_profile.txt"), "w") as f:
            f.write("\n".join(tables))
    print(chip_smoke.nvidia_smi())


if __name__ == "__main__":
    main()
