"""gemma3-1b [dense]: 26L d_model=1152 4H (kv=1, head_dim 256) d_ff=6912
vocab=262144 — 5:1 local:global sliding-window (512), qk-norm, gated GELU
[hf:google/gemma-3-1b-pt]. Local layers make long_500k decode linear.
"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma3-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense", block_type="attn",
        num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
        head_dim=256, d_ff=6912, vocab_size=262144,
        sliding_window=512, global_every=6, qk_norm=True,
        activation="gelu", rope_theta=1e6, tie_embeddings=True,
        subquadratic=True)
