"""paligemma-3b [vlm]: gemma-2B text backbone, 18L d_model=2048 8H (kv=1)
d_ff=16384 vocab=257216; SigLIP frontend is a STUB — input_specs() provides
256 precomputed patch embeddings at dim 1152, projected to d_model
[arXiv:2407.07726].
"""
from repro_torch.configs.base import ModelConfig, register


@register("paligemma-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm", block_type="attn",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        head_dim=256, d_ff=16384, vocab_size=257216,
        vision_tokens=256, vision_dim=1152,
        activation="gelu", rope_theta=1e4, tie_embeddings=True)
