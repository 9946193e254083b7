"""granite-moe-1b-a400m [moe] — IBM Granite 3.0 1B-A400M base.

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""

from repro_torch.configs import lm_common
from repro_torch.models import moe as moe_mod, transformer as tf


def full_config() -> tf.LMConfig:
    return tf.LMConfig(
        name="granite-moe-1b-a400m",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=0, vocab=49155, act="silu", gated_mlp=True,
        tie_embeddings=True,   # granite ties input/output embeddings
        moe=moe_mod.MoeConfig(
            d_model=1024, d_ff=512, n_experts=32, top_k=8,
            capacity_factor=1.25, act="silu", gated=True,
            dispatch_groups=32,   # group-local dispatch
        ),
    )


def smoke_config() -> tf.LMConfig:
    return tf.LMConfig(
        name="granite-moe-1b-a400m-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=0, vocab=128, act="silu", gated_mlp=True,
        tie_embeddings=True, remat=False,
        moe=moe_mod.MoeConfig(
            d_model=64, d_ff=32, n_experts=4, top_k=2,
            capacity_factor=1.25, act="silu", gated=True,
        ),
    )


SPEC = lm_common.make_lm_spec("granite-moe-1b-a400m", full_config, smoke_config)
