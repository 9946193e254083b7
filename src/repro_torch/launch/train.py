"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of :mod:`repro.launch.train` for the LM family: runs the
fault-tolerant training loop on the arch's smoke config, with batches from
the IDL n-gram dedup pipeline and the chunked loss (4 chunks), on
``--device`` (default ``cuda``; ``cpu`` runs the same code on the host).
The recsys and GNN archs have no port yet (ROADMAP items 14c and 14d);
``idl-genesearch`` is serve-only, as in the reference.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --device cpu --steps 6 --batch 2 --seq 32
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.data import lm_pipeline
from repro_torch.models import transformer as tf
from repro_torch.train import loop, optimizer as opt_mod

# the reference's trainable archs the port does not have yet, by ROADMAP item
NOT_PORTED = {
    "sasrec": "14c", "fm": "14c", "two-tower-retrieval": "14c",
    "mind": "14c", "equiformer-v2": "14d",
}


def lm_runner(spec, args):
    """(params, loss_fn, next_batch, pipeline) of an LM arch's smoke config
    on ``args.device``."""
    cfg = spec.make_smoke_config()
    pipe = lm_pipeline.LMPipeline(lm_pipeline.LMPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        dedup=True, dedup_scheme="idl"))
    params = tf.lm_init(args.seed, cfg, device=args.device).params()

    def loss(p, b):
        return tf.lm_loss(p, b, cfg, loss_chunks=4)

    def batch_fn():
        return {k: torch.from_numpy(v).to(args.device)
                for k, v in pipe.next_batch().items()}
    return params, loss, batch_fn, pipe


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args(argv)

    if args.arch in NOT_PORTED:
        raise SystemExit(
            f"{args.arch} is not ported yet: the port trains the LM family "
            f"only (ROADMAP item {NOT_PORTED[args.arch]})")
    spec = configs.get(args.arch)
    if spec.family != "lm":
        raise SystemExit(f"{args.arch} has no train step (serve-only arch); "
                         f"use repro_torch.launch.serve")
    params, loss, batch_fn, pipe = lm_runner(spec, args)

    lcfg = loop.LoopConfig(
        total_steps=args.steps, ckpt_every=max(args.steps // 4, 1),
        ckpt_dir=args.ckpt_dir, log_every=max(args.steps // 10, 1))
    result = loop.run(
        loss, params, opt_mod.make_optimizer(args.optimizer, args.lr),
        batch_fn, lcfg,
        pipeline_state=pipe.state_dict, restore_pipeline=pipe.load_state_dict)
    for h in result.history:
        print(h)
    print(f"done: {args.arch} loss {result.history[0]['loss']:.4f} -> "
          f"{result.history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
