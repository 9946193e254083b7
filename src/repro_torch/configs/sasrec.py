"""sasrec [recsys] — self-attentive sequential recommendation.

embed_dim=50 n_blocks=2 n_heads=1 seq_len=50. [arXiv:1808.09781; paper]
"""

from __future__ import annotations

import torch

from repro_torch.configs import recsys_common
from repro_torch.configs.base import abstract
from repro_torch.models import recsys


def full_config() -> recsys.SASRecConfig:
    return recsys.SASRecConfig(
        name="sasrec", embed_dim=50, n_blocks=2, n_heads=1, seq_len=50,
        n_items=1 << 20,
    )


def smoke_config() -> recsys.SASRecConfig:
    return recsys.SASRecConfig(
        name="sasrec-smoke", embed_dim=16, n_blocks=2, n_heads=1, seq_len=12,
        n_items=1 << 10,
    )


def score(params, batch, cfg):
    """Per-request next-item scores against the given candidate set."""
    h = recsys.sasrec_forward(params, batch["seq"], cfg)[:, -1, :]  # (B, d)
    rows = recsys.hash_rows(batch["cands"], cfg.n_items, cfg.hash_scheme)
    ce = recsys.take_rows(params["item_table"], rows)               # (B, C, d)
    return torch.einsum("bd,bcd->bc", h, ce).float()


def retrieval(params, batch, cfg):
    """One session vs 1M candidates: a single gather + matvec, not a loop."""
    h = recsys.sasrec_forward(params, batch["seq"], cfg)[0, -1, :]  # (d,)
    rows = recsys.hash_rows(batch["cands"], cfg.n_items, cfg.hash_scheme)
    ce = recsys.take_rows(params["item_table"], rows)               # (N, d)
    return (ce @ h).float()


def train_inputs(cfg, cell):
    b, s = cell.meta["batch"], cfg.seq_len
    return {k: abstract((b, s), torch.int32) for k in ("seq", "pos", "neg")}


def score_inputs(cfg, cell):
    b = cell.meta["batch"]
    return {"seq": abstract((b, cfg.seq_len), torch.int32),
            "cands": abstract((b, 100), torch.int32)}


def retrieval_inputs(cfg, cell):
    return {"seq": abstract((1, cfg.seq_len), torch.int32),
            "cands": abstract((cell.meta["candidates"],), torch.int32)}


def model_flops(cfg: recsys.SASRecConfig, cell) -> float:
    b = cell.meta["batch"]
    s, d = cfg.seq_len, cfg.embed_dim
    per_tok = cfg.n_blocks * (4 * d * d + 8 * d * d) * 2   # attn + 4x mlp
    attn = cfg.n_blocks * 2 * s * s * d * 2
    fwd = b * (s * per_tok + attn)
    if cell.kind == "train":
        return 3.0 * fwd
    if cell.meta.get("mode") == "retrieval":
        return fwd + 2.0 * cell.meta["candidates"] * d
    return fwd + 2.0 * b * 100 * d


SPEC = recsys_common.make_recsys_spec(
    "sasrec", full_config, smoke_config,
    init_fn=recsys.sasrec_init, loss_fn=recsys.sasrec_loss,
    score_fn=score, retrieval_fn=retrieval,
    train_inputs=train_inputs, score_inputs=score_inputs,
    retrieval_inputs=retrieval_inputs,
    model_flops_fn=model_flops,
)
