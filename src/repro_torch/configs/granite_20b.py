"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1, head_dim 128)
d_ff=24576 vocab=49152 — code model, gpt_bigcode-style MQA with plain
(non-gated) GELU MLP [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig, register


@register("granite-20b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense", block_type="attn",
        num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
        head_dim=128, d_ff=24576, vocab_size=49152,
        activation="gelu", gated_mlp=False, rope_theta=1e4,
        tie_embeddings=True)
