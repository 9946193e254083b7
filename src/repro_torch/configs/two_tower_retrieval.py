"""two-tower-retrieval [recsys] — sampled-softmax retrieval (YouTube '19).

embed_dim=256 tower_mlp=1024-512-256 interaction=dot. [RecSys'19; unverified]
"""

from __future__ import annotations

import torch

from repro_torch.configs import recsys_common
from repro_torch.configs.base import abstract
from repro_torch.models import recsys


def full_config() -> recsys.TwoTowerConfig:
    return recsys.TwoTowerConfig(
        name="two-tower-retrieval", embed_dim=256,
        tower_dims=(1024, 512, 256), n_users=1 << 23, n_items=1 << 23,
    )


def smoke_config() -> recsys.TwoTowerConfig:
    return recsys.TwoTowerConfig(
        name="two-tower-smoke", embed_dim=16, tower_dims=(32, 16),
        n_users=1 << 10, n_items=1 << 10,
    )


def score(params, batch, cfg):
    u, it = recsys.twotower_embed(params, batch, cfg)
    return torch.sum(u * it, dim=-1).float()


def train_inputs(cfg, cell):
    b = cell.meta["batch"]
    return {"user_feats": abstract((b, cfg.n_user_feats), torch.int32),
            "item_feats": abstract((b, cfg.n_item_feats), torch.int32)}


score_inputs = train_inputs


def retrieval_inputs(cfg, cell):
    return {"user_feats": abstract((1, cfg.n_user_feats), torch.int32),
            "cand_feats": abstract((cell.meta["candidates"],
                                    cfg.n_item_feats), torch.int32)}


def model_flops(cfg: recsys.TwoTowerConfig, cell) -> float:
    def tower_flops(d_in):
        f, prev = 0, d_in
        for d in cfg.tower_dims:
            f += 2 * prev * d
            prev = d
        return f
    ut = tower_flops(cfg.n_user_feats * cfg.embed_dim)
    it = tower_flops(cfg.n_item_feats * cfg.embed_dim)
    if cell.kind == "train":
        b = cell.meta["batch"]
        return 3.0 * b * (ut + it + 2 * b * cfg.tower_dims[-1])
    if cell.meta.get("mode") == "retrieval":
        n = cell.meta["candidates"]
        return float(ut + n * it + 2 * n * cfg.tower_dims[-1])
    b = cell.meta["batch"]
    return float(b * (ut + it + 2 * cfg.tower_dims[-1]))


SPEC = recsys_common.make_recsys_spec(
    "two-tower-retrieval", full_config, smoke_config,
    init_fn=recsys.twotower_init, loss_fn=recsys.twotower_loss,
    score_fn=score, retrieval_fn=recsys.twotower_score_candidates,
    train_inputs=train_inputs, score_inputs=score_inputs,
    retrieval_inputs=retrieval_inputs,
    model_flops_fn=model_flops,
)
