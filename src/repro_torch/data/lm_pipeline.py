"""LM token pipeline: synthetic corpus + IDL-BF n-gram dedup + batching.

Port of :mod:`repro.data.lm_pipeline`, host-side numpy as in the
reference (the filter is a streaming 4 Mbit bitmap probed a document at a
time), with the port's own ``np_hash64`` / ``np_hash_to_range``: batches,
drops and the probe byte trace are exactly the reference's.

This is where the paper's technique meets the LM archs: training-data
n-gram dedup is a membership test over a sliding window of token n-grams —
structurally the gene kmer search. Sequential n-grams of one document are
near-duplicates of each other, so an IDL-hashed Bloom filter gives the same
probe-locality win as on genomic reads; an RH-hashed filter is the
baseline.

Deterministic resume: the pipeline's cursor is part of its state dict and
is saved and restored by the checkpoint layer; restoring replays the
filter up to the cursor, so a restarted job sees the exact token order and
dedup decisions.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import hashing


@dataclasses.dataclass
class LMPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_docs: int = 4096
    doc_len: int = 512
    dedup: bool = True
    dedup_ngram: int = 8
    dedup_bf_bits: int = 1 << 22
    dedup_eta: int = 2
    dedup_scheme: str = "idl"   # "idl" | "rh" — technique integration point
    dedup_L: int = 1 << 12


class _NgramBF:
    """Host-side Bloom filter over token n-grams (numpy; streaming scale).

    IDL scheme: exactly the paper's construction with t=1 sub-tokens —
    anchor = RH(MinHash over the n-token window) (consecutive windows share
    their min with prob (n-1)/(n+1), like overlapping kmers share sub-kmers),
    local = RH(full n-gram) in [L]. RH scheme: plain per-n-gram hash.
    """

    def __init__(self, cfg: LMPipelineConfig):
        self.cfg = cfg
        self.bits = np.zeros(cfg.dedup_bf_bits // 8, dtype=np.uint8)
        self.probes = 0
        self.byte_trace: list[np.ndarray] = []

    def _locations_idl(self, ngrams: np.ndarray, anchors: np.ndarray,
                       j: int, m_part: int) -> np.ndarray:
        cfg = self.cfg
        anchor = hashing.np_hash_to_range(
            anchors, 0xA17C + 31 * j, max(m_part // cfg.dedup_L, 1)
        ).astype(np.int64) * cfg.dedup_L
        local = hashing.np_hash_to_range(
            ngrams, 0x10CA + 31 * j, cfg.dedup_L
        ).astype(np.int64)
        return anchor + local + j * m_part

    def _locations_rh(self, ngrams: np.ndarray, anchors: np.ndarray,
                      j: int, m_part: int) -> np.ndarray:
        del anchors
        return hashing.np_hash_to_range(
            ngrams, 0x5EED + 31 * j, m_part
        ).astype(np.int64) + j * m_part

    def _locations(self, ngrams: np.ndarray, anchors: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        m_part = cfg.dedup_bf_bits // cfg.dedup_eta
        loc_fn = {"idl": self._locations_idl}.get(
            cfg.dedup_scheme, self._locations_rh)
        return np.stack(
            [loc_fn(ngrams, anchors, j, m_part) for j in range(cfg.dedup_eta)],
            axis=0,
        )  # (eta, n)

    def check_and_insert(self, tokens: np.ndarray) -> float:
        """Returns the fraction of the doc's n-grams already seen."""
        n = self.cfg.dedup_ngram
        if len(tokens) < n:
            return 0.0
        # rolling pack: polynomial hash of each n-gram window; anchor from a
        # rolling MinHash of per-token hashes over the same window
        base = np.uint64(1000003)
        t = tokens.astype(np.uint64)
        n_out = len(t) - n + 1
        ngrams = np.zeros(n_out, dtype=np.uint64)
        with np.errstate(over="ignore"):
            for j in range(n):
                ngrams = ngrams * base + t[j : j + n_out]
        htok = hashing.np_hash64(t, 0x0D0F)
        windows = np.lib.stride_tricks.sliding_window_view(htok, n)
        minh = windows.min(axis=1)                   # (n_out,) rolling MinHash
        locs = self._locations(ngrams, minh)
        self.probes += locs.size
        self.byte_trace.append(locs.reshape(-1) // 8)
        byte_idx = (locs // 8).astype(np.int64)
        bit = (locs % 8).astype(np.uint8)
        present = ((self.bits[byte_idx] >> bit) & 1).all(axis=0)
        np.bitwise_or.at(self.bits, byte_idx.reshape(-1), (np.uint8(1) << bit).reshape(-1))
        return float(present.mean())


class LMPipeline:
    """Deterministic synthetic-document stream with n-gram dedup filtering."""

    def __init__(self, cfg: LMPipelineConfig):
        self.cfg = cfg
        self.cursor = 0
        self.bf = _NgramBF(cfg) if cfg.dedup else None
        self.dropped = 0
        self._buf: list[np.ndarray] = []

    # -- deterministic doc source ------------------------------------------
    def _doc(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.cfg.seed * 1_000_003 + i)
        doc = rng.integers(1, self.cfg.vocab, size=self.cfg.doc_len, dtype=np.int32)
        # plant exact duplicates: every 7th doc repeats doc i-7
        if i % 7 == 0 and i >= 7:
            return self._doc(i - 7)
        return doc

    def state_dict(self) -> dict:
        return {"cursor": self.cursor, "dropped": self.dropped}

    def load_state_dict(self, state: dict) -> None:
        # replay the BF to the cursor for exact-resume dedup decisions
        self.cursor = 0
        self.dropped = 0
        self.bf = _NgramBF(self.cfg) if self.cfg.dedup else None
        self._buf = []
        target = int(state["cursor"])
        while self.cursor < target:
            self._pull_doc()
        self._buf = []  # batches already consumed

    def _pull_doc(self) -> None:
        doc = self._doc(self.cursor)
        self.cursor += 1
        if self.bf is not None:
            dup_frac = self.bf.check_and_insert(doc)
            if dup_frac > 0.5:
                self.dropped += 1
                return
        self._buf.append(doc)

    def next_batch(self) -> dict[str, np.ndarray]:
        """(tokens, labels) of shape (global_batch, seq_len)."""
        cfg = self.cfg
        need = cfg.global_batch * (cfg.seq_len + 1)
        stream: list[np.ndarray] = []
        total = 0
        while total < need:
            while not self._buf:
                self._pull_doc()
            d = self._buf.pop(0)
            stream.append(d)
            total += len(d)
        flat = np.concatenate(stream)[:need].reshape(cfg.global_batch, cfg.seq_len + 1)
        return {"tokens": flat[:, :-1].astype(np.int32),
                "labels": flat[:, 1:].astype(np.int32)}
