"""granite-20b [dense] — IBM Granite 20B code model.

52L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576 vocab=49152.
GPT-BigCode lineage: non-gated GELU MLP, multi-query attention.
[arXiv:2405.04324; hf]
"""

from repro_torch.configs import lm_common
from repro_torch.models import transformer as tf


def full_config() -> tf.LMConfig:
    return tf.LMConfig(
        name="granite-20b",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab=49152, act="gelu", gated_mlp=False,
    )


def smoke_config() -> tf.LMConfig:
    return tf.LMConfig(
        name="granite-20b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=256, vocab=128, act="gelu", gated_mlp=False, remat=False,
    )


SPEC = lm_common.make_lm_spec("granite-20b", full_config, smoke_config)
