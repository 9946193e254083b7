"""RecSys click/session synthesis for the four recsys archs.

Port of :mod:`repro.data.recsys_pipeline`: host-side numpy, as in the
reference, so every batch is exactly the reference's for the same seed.

Sessions have *temporal locality* in their item ids (users browse related
items whose raw ids cluster) — exactly the correlation the IDL-hashed
embedding-row assignment exploits (models/recsys.hash_rows scheme="idl").
The generator plants that structure so the locality benchmarks measure
something real rather than iid ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RecsysSynthConfig:
    n_items: int = 1 << 20
    n_users: int = 1 << 18
    session_len: int = 50
    locality: float = 0.8      # prob. next item is near the previous one
    neighborhood: int = 256    # id radius of "related" items
    seed: int = 0


class SessionGenerator:
    def __init__(self, cfg: RecsysSynthConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)

    def sessions(self, batch: int) -> np.ndarray:
        """(batch, session_len) int32 item ids with planted locality."""
        cfg = self.cfg
        out = np.empty((batch, cfg.session_len), dtype=np.int64)
        cur = self.rng.integers(0, cfg.n_items, size=batch)
        for s in range(cfg.session_len):
            jump = self.rng.random(batch) >= cfg.locality
            near = (
                cur + self.rng.integers(-cfg.neighborhood, cfg.neighborhood + 1, size=batch)
            ) % cfg.n_items
            far = self.rng.integers(0, cfg.n_items, size=batch)
            cur = np.where(jump, far, near)
            out[:, s] = cur
        return out.astype(np.int32)

    # -- per-arch batch builders -------------------------------------------
    def sasrec_batch(self, batch: int) -> dict[str, np.ndarray]:
        seq = self.sessions(batch)
        pos = np.roll(seq, -1, axis=1)
        pos[:, -1] = self.rng.integers(0, self.cfg.n_items, size=batch)
        neg = self.rng.integers(0, self.cfg.n_items, size=seq.shape).astype(np.int32)
        return {"seq": seq, "pos": pos.astype(np.int32), "neg": neg}

    def mind_batch(self, batch: int, n_negs: int = 10) -> dict[str, np.ndarray]:
        seq = self.sessions(batch)
        return {
            "seq": seq,
            "mask": np.ones(seq.shape, np.float32),
            "pos": self.rng.integers(0, self.cfg.n_items, size=batch).astype(np.int32),
            "negs": self.rng.integers(
                0, self.cfg.n_items, size=(batch, n_negs)
            ).astype(np.int32),
        }

    def fm_batch(self, batch: int, n_sparse: int = 39,
                 vocab_per_field: int = 1 << 20) -> dict[str, np.ndarray]:
        feats = self.rng.integers(0, vocab_per_field, size=(batch, n_sparse))
        # label correlates with a planted linear rule so training can learn
        signal = (feats[:, 0] % 7 == 0) | (feats[:, 3] % 11 == 0)
        noise = self.rng.random(batch) < 0.1
        return {
            "feats": feats.astype(np.int32),
            "labels": (signal ^ noise).astype(np.int32),
        }

    def twotower_batch(self, batch: int, n_user_feats: int = 8,
                       n_item_feats: int = 4) -> dict[str, np.ndarray]:
        return {
            "user_feats": self.rng.integers(
                0, self.cfg.n_users, size=(batch, n_user_feats)
            ).astype(np.int32),
            "item_feats": self.rng.integers(
                0, self.cfg.n_items, size=(batch, n_item_feats)
            ).astype(np.int32),
        }

    def retrieval_batch(self, n_candidates: int,
                        n_user_feats: int = 8, n_item_feats: int = 4) -> dict:
        return {
            "user_feats": self.rng.integers(
                0, self.cfg.n_users, size=(1, n_user_feats)
            ).astype(np.int32),
            "cand_feats": self.rng.integers(
                0, self.cfg.n_items, size=(n_candidates, n_item_feats)
            ).astype(np.int32),
        }
