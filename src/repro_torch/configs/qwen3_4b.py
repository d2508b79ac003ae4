"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8, head_dim 128)
d_ff=9728 vocab=151936, qk-norm [hf:Qwen/Qwen3-4B]."""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense", block_type="attn",
        num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=9728, vocab_size=151936,
        qk_norm=True, rope_theta=1e6, tie_embeddings=True)
