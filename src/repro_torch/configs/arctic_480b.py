"""arctic-480b [moe] — Snowflake Arctic base.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts top-2
plus a dense residual FFN path (Arctic's dense-MoE hybrid).
[hf:Snowflake/snowflake-arctic-base; hf]
"""

from repro_torch.configs import lm_common
from repro_torch.models import moe as moe_mod, transformer as tf


def full_config() -> tf.LMConfig:
    return tf.LMConfig(
        name="arctic-480b",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=0, vocab=32000, act="silu", gated_mlp=True,
        moe=moe_mod.MoeConfig(
            d_model=7168, d_ff=4864, n_experts=128, top_k=2,
            capacity_factor=1.25, act="silu", gated=True,
            residual_d_ff=4864,
            dispatch_groups=32,   # group-local dispatch
        ),
    )


def smoke_config() -> tf.LMConfig:
    return tf.LMConfig(
        name="arctic-480b-smoke",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=0, vocab=128, act="silu", gated_mlp=True, remat=False,
        moe=moe_mod.MoeConfig(
            d_model=64, d_ff=32, n_experts=8, top_k=2,
            capacity_factor=1.25, act="silu", gated=True, residual_d_ff=32,
        ),
    )


SPEC = lm_common.make_lm_spec("arctic-480b", full_config, smoke_config)
