"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of :mod:`repro.launch.train`: runs the fault-tolerant training loop
for any trainable arch at a REDUCED scale (the arch's smoke config) on
``--device`` (default ``cuda``; ``cpu`` runs the same code on the host).
An LM trains on batches from the IDL n-gram dedup pipeline with the
chunked loss (4 chunks); a recsys arch on ``SessionGenerator`` batches;
the Equiformer (8 classes) on fanout-sampled subgraphs of a synthetic
512-node graph. ``idl-genesearch`` is serve-only, as in the reference.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --device cpu --steps 6 --batch 2 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch fm --device cpu \\
        --steps 10 --batch 32
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.data import graph_pipeline, lm_pipeline, recsys_pipeline
from repro_torch.models import equiformer as eq, recsys, transformer as tf
from repro_torch.train import loop, optimizer as opt_mod


def _on(device, batch: dict) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


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
    return params, loss, lambda: _on(args.device, pipe.next_batch()), pipe


def gnn_runner(spec, args):
    """The Equiformer's smoke config with 8 classes, on padded fanout
    batches (5-5 from ``args.batch`` seeds) of a 512-node graph."""
    cfg = dataclasses.replace(spec.make_smoke_config(), n_classes=8)
    g = graph_pipeline.synth_graph(512, 4096, n_classes=8, seed=args.seed)
    loader = graph_pipeline.FanoutLoader(g, args.batch, [5, 5], 1024, 8192)
    params = eq.equiformer_init(args.seed, cfg, device=args.device)

    def loss(p, b):
        return eq.equiformer_loss(p, b, cfg)
    return params, loss, lambda: _on(args.device, loader.next_batch()), None


# arch -> (init, loss, SessionGenerator batch of (generator, cfg, batch))
_RECSYS = {
    "sasrec": (recsys.sasrec_init, recsys.sasrec_loss,
               lambda gen, cfg, b: gen.sasrec_batch(b)),
    "fm": (recsys.fm_init, recsys.fm_loss,
           lambda gen, cfg, b: gen.fm_batch(b, cfg.n_sparse,
                                            cfg.vocab_per_field)),
    "two-tower-retrieval": (recsys.twotower_init, recsys.twotower_loss,
                            lambda gen, cfg, b: gen.twotower_batch(b)),
    "mind": (recsys.mind_init, recsys.mind_loss,
             lambda gen, cfg, b: gen.mind_batch(b)),
}


def recsys_runner(spec, args):
    """A recsys arch's smoke config on ``SessionGenerator`` batches."""
    cfg = spec.make_smoke_config()
    gen = recsys_pipeline.SessionGenerator(recsys_pipeline.RecsysSynthConfig(
        n_items=getattr(cfg, "n_items", 1 << 10),
        session_len=getattr(cfg, "seq_len", 12), seed=args.seed))
    init, loss_fn, make = _RECSYS[spec.name]
    params = init(args.seed, cfg, device=args.device)

    def loss(p, b):
        return loss_fn(p, b, cfg)
    return (params, loss,
            lambda: _on(args.device, make(gen, cfg, args.batch)), None)


RUNNERS = {"lm": lm_runner, "gnn": gnn_runner, "recsys": recsys_runner}


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

    spec = configs.get(args.arch)
    if spec.family not in RUNNERS:
        raise SystemExit(f"{args.arch} has no train step (serve-only arch); "
                         f"use repro_torch.launch.serve")
    params, loss, batch_fn, pipe = RUNNERS[spec.family](spec, args)

    lcfg = loop.LoopConfig(
        total_steps=args.steps, ckpt_every=max(args.steps // 4, 1),
        ckpt_dir=args.ckpt_dir, log_every=max(args.steps // 10, 1))
    result = loop.run(
        loss, params, opt_mod.make_optimizer(args.optimizer, args.lr),
        batch_fn, lcfg,
        pipeline_state=pipe.state_dict if pipe else None,
        restore_pipeline=pipe.load_state_dict if pipe else None)
    for h in result.history:
        print(h)
    print(f"done: {args.arch} loss {result.history[0]['loss']:.4f} -> "
          f"{result.history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
