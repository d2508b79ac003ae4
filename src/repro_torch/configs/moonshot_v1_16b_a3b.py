"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16, MHA) 64 experts
top-6, d_ff(expert)=1408, vocab=163840 + 2 shared experts (DeepSeek-style)
[hf:moonshotai/Moonlight-16B-A3B].

Adaptation note: Moonlight's first dense layer is modeled as MoE like the
rest (homogeneous scan stack); see DESIGN.md §4.
"""
from repro_torch.configs.base import ModelConfig, register


@register("moonshot-v1-16b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe", block_type="attn",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=0, vocab_size=163840,
        num_experts=64, experts_per_token=6, moe_d_ff=1408,
        shared_experts=2, rope_theta=5e4, tie_embeddings=False)
