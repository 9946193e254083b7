"""internlm2-20b [dense] — InternLM2 20B.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544, SwiGLU.
[arXiv:2403.17297; hf]
"""

from repro_torch.configs import lm_common
from repro_torch.models import transformer as tf


def full_config() -> tf.LMConfig:
    return tf.LMConfig(
        name="internlm2-20b",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=92544, act="silu", gated_mlp=True,
        rope_theta=1000000.0,
    )


def smoke_config() -> tf.LMConfig:
    return tf.LMConfig(
        name="internlm2-20b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab=128, act="silu", gated_mlp=True, remat=False,
        rope_theta=1000000.0,
    )


SPEC = lm_common.make_lm_spec("internlm2-20b", full_config, smoke_config)
