"""mind [recsys] — multi-interest dynamic-routing capsule network.

embed_dim=64 n_interests=4 capsule_iters=3. [arXiv:1904.08030; unverified]
"""

from __future__ import annotations

import torch

from repro_torch.configs import recsys_common
from repro_torch.configs.base import abstract
from repro_torch.models import recsys


def full_config() -> recsys.MINDConfig:
    return recsys.MINDConfig(
        name="mind", embed_dim=64, n_interests=4, capsule_iters=3,
        seq_len=50, n_items=1 << 20,
    )


def smoke_config() -> recsys.MINDConfig:
    return recsys.MINDConfig(
        name="mind-smoke", embed_dim=16, n_interests=2, capsule_iters=2,
        seq_len=12, n_items=1 << 10,
    )


def score(params, batch, cfg):
    """Max-over-interests dot against per-request candidates."""
    v = recsys.mind_interests(params, batch["seq"], batch["mask"], cfg)
    rows = recsys.hash_rows(batch["cands"], cfg.n_items, cfg.hash_scheme)
    ce = recsys.take_rows(params["item_table"], rows)          # (B, C, d)
    s = torch.einsum("bkd,bcd->bkc", v, ce)
    return torch.amax(s, dim=1).float()


def retrieval(params, batch, cfg):
    v = recsys.mind_interests(params, batch["seq"], batch["mask"], cfg)[0]
    rows = recsys.hash_rows(batch["cands"], cfg.n_items, cfg.hash_scheme)
    ce = recsys.take_rows(params["item_table"], rows)          # (N, d)
    return torch.amax(ce @ v.T, dim=-1).float()


def train_inputs(cfg, cell):
    b, s = cell.meta["batch"], cfg.seq_len
    return {"seq": abstract((b, s), torch.int32),
            "mask": abstract((b, s), torch.float32),
            "pos": abstract((b,), torch.int32),
            "negs": abstract((b, 10), torch.int32)}


def score_inputs(cfg, cell):
    b = cell.meta["batch"]
    return {"seq": abstract((b, cfg.seq_len), torch.int32),
            "mask": abstract((b, cfg.seq_len), torch.float32),
            "cands": abstract((b, 100), torch.int32)}


def retrieval_inputs(cfg, cell):
    return {"seq": abstract((1, cfg.seq_len), torch.int32),
            "mask": abstract((1, cfg.seq_len), torch.float32),
            "cands": abstract((cell.meta["candidates"],), torch.int32)}


def model_flops(cfg: recsys.MINDConfig, cell) -> float:
    b = cell.meta["batch"]
    s, d, k = cfg.seq_len, cfg.embed_dim, cfg.n_interests
    routing = cfg.capsule_iters * (2 * k * s * d * 2)
    fwd = b * (s * 2 * d * d + routing)
    if cell.kind == "train":
        return 3.0 * fwd
    if cell.meta.get("mode") == "retrieval":
        return fwd + 2.0 * cell.meta["candidates"] * d * k
    return fwd + 2.0 * b * 100 * d * k


SPEC = recsys_common.make_recsys_spec(
    "mind", full_config, smoke_config,
    init_fn=recsys.mind_init, loss_fn=recsys.mind_loss,
    score_fn=score, retrieval_fn=retrieval,
    train_inputs=train_inputs, score_inputs=score_inputs,
    retrieval_inputs=retrieval_inputs,
    model_flops_fn=model_flops,
)
