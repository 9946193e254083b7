"""End-to-end training example of the PyTorch port: train a 56M-param
granite-style LM for a few hundred steps with the IDL-BF dedup pipeline,
checkpointing and fault-tolerance hooks — the port of
``examples/train_lm.py``, on ``--device`` (default ``cuda``; ``cpu``
runs the same steps, slowly).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200

Checkpoints go to ``--ckpt-dir`` (resumed from when it holds one), or to a
temporary directory removed at the end.
"""

import argparse
import shutil
import tempfile
import time

import torch

from repro_torch.data import lm_pipeline
from repro_torch.models import transformer as tf
from repro_torch.train import loop, optimizer as opt_mod


def build_config() -> tf.LMConfig:
    # 56M params: 12L x 512d x 8H, vocab 8192
    return tf.LMConfig(
        name="granite-100m", n_layers=12, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=2048, vocab=8192, act="silu", gated_mlp=True,
        remat=False,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    args = ap.parse_args(argv)

    cfg = build_config()
    n_params = cfg.param_count()
    print(f"model: {cfg.name} ({n_params / 1e6:.0f}M params) on {args.device}")

    pipe = lm_pipeline.LMPipeline(lm_pipeline.LMPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        dedup=True, dedup_scheme="idl"))

    def next_batch():
        return {k: torch.from_numpy(v).to(args.device)
                for k, v in pipe.next_batch().items()}

    params = tf.lm_init(0, cfg, device=args.device).params()
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="torch_train_lm_")
    lcfg = loop.LoopConfig(
        total_steps=args.steps, ckpt_every=50, ckpt_dir=ckpt_dir,
        log_every=10, grad_clip=1.0)
    try:
        t0 = time.perf_counter()
        result = loop.run(
            lambda p, b: tf.lm_loss(p, b, cfg, loss_chunks=8),
            params, opt_mod.adamw(3e-4), next_batch, lcfg,
            pipeline_state=pipe.state_dict,
            restore_pipeline=pipe.load_state_dict,
        )
        wall = time.perf_counter() - t0
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

    first = result.history[0]["loss"]
    last = result.history[-1]["loss"]
    steps = int(result.state.step) - (result.resumed_from or 0)
    print(f"\nstep {result.history[-1]['step']}: loss {first:.3f} -> {last:.3f}"
          f" (dedup dropped {pipe.dropped} docs; {steps / wall:.2f} steps/s "
          f"over {wall:.1f} s, checkpoints included)")
    if result.resumed_from:
        print(f"(resumed from checkpoint step {result.resumed_from})")
    assert last < first, "loss must decrease"
    print("ok")


if __name__ == "__main__":
    main()
