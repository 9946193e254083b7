"""mind [recsys] — multi-interest dynamic-routing capsule network.

embed_dim=64 n_interests=4 capsule_iters=3. [arXiv:1904.08030; unverified]
"""

from __future__ import annotations

import torch

from repro_torch.configs import recsys_common
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
    loss_fn=recsys.mind_loss, score_fn=score, retrieval_fn=retrieval,
    model_flops_fn=model_flops,
)
