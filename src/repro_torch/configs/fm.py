"""fm [recsys] — factorization machine (Rendle, ICDM'10).

n_sparse=39 embed_dim=10, pairwise interactions via the O(nk) sum-square
trick. [ICDM'10; paper]
"""

from __future__ import annotations

import torch

from repro_torch.configs import recsys_common
from repro_torch.configs.base import abstract
from repro_torch.models import recsys


def full_config() -> recsys.FMConfig:
    return recsys.FMConfig(name="fm", n_sparse=39, embed_dim=10,
                           vocab_per_field=1 << 20)


def smoke_config() -> recsys.FMConfig:
    return recsys.FMConfig(name="fm-smoke", n_sparse=8, embed_dim=4,
                           vocab_per_field=256)


def score(params, batch, cfg):
    return recsys.fm_forward(params, batch["feats"], cfg)


def retrieval(params, batch, cfg):
    """Fixed user context x 1M candidate items: the candidate id fills the
    last field, the other fields broadcast — one batched forward."""
    n = batch["cands"].shape[0]
    feats = batch["context"].expand(n, cfg.n_sparse).clone()
    feats[:, -1] = batch["cands"]
    return recsys.fm_forward(params, feats, cfg)


def train_inputs(cfg, cell):
    b = cell.meta["batch"]
    return {"feats": abstract((b, cfg.n_sparse), torch.int32),
            "labels": abstract((b,), torch.int32)}


def score_inputs(cfg, cell):
    b = cell.meta["batch"]
    return {"feats": abstract((b, cfg.n_sparse), torch.int32)}


def retrieval_inputs(cfg, cell):
    return {"context": abstract((1, cfg.n_sparse), torch.int32),
            "cands": abstract((cell.meta["candidates"],), torch.int32)}


def model_flops(cfg: recsys.FMConfig, cell) -> float:
    b = cell.meta.get("candidates", cell.meta["batch"])
    fwd = b * cfg.n_sparse * cfg.embed_dim * 4     # sum-square trick
    return 3.0 * fwd if cell.kind == "train" else float(fwd)


SPEC = recsys_common.make_recsys_spec(
    "fm", full_config, smoke_config,
    init_fn=recsys.fm_init, loss_fn=recsys.fm_loss,
    score_fn=score, retrieval_fn=retrieval,
    train_inputs=train_inputs, score_inputs=score_inputs,
    retrieval_inputs=retrieval_inputs,
    model_flops_fn=model_flops,
)
