"""nemotron-4-340b [dense] — NVIDIA Nemotron-4 340B.

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000, squared-ReLU
non-gated MLP. [arXiv:2402.16819; unverified]
"""

from repro_torch.configs import lm_common
from repro_torch.models import transformer as tf


def full_config() -> tf.LMConfig:
    return tf.LMConfig(
        name="nemotron-4-340b",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
        d_ff=73728, vocab=256000, act="relu2", gated_mlp=False,
    )


def smoke_config() -> tf.LMConfig:
    return tf.LMConfig(
        name="nemotron-4-340b-smoke",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=384, vocab=128, act="relu2", gated_mlp=False, remat=False,
    )


SPEC = lm_common.make_lm_spec("nemotron-4-340b", full_config, smoke_config)
