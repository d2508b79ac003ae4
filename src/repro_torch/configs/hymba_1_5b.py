"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676].

Adaptation notes (DESIGN.md §4): hymba's meta-tokens are omitted (constant
prefix, orthogonal to the systems contribution); attention and SSM head
outputs are mean-fused per block.
"""
from repro_torch.configs.base import ModelConfig, register


@register("hymba-1.5b")
def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid", block_type="hybrid",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        head_dim=64, d_ff=5504, vocab_size=32001,
        ssm_state=16, ssm_head_dim=64, ssm_expand=2,
        rope_theta=1e4, tie_embeddings=True, subquadratic=True)
