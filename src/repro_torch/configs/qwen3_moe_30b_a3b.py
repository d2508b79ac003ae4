"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4, head_dim 128)
128 experts top-8, d_ff(expert)=768, vocab=151936 [hf:Qwen/Qwen3-30B-A3B].
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-moe-30b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", block_type="attn",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=0, vocab_size=151936,
        num_experts=128, experts_per_token=8, moe_d_ff=768,
        qk_norm=True, rope_theta=1e6, tie_embeddings=False)
