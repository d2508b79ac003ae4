"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060].

Pure Mamba2 blocks (norm -> SSD mixer -> residual; no MLP, d_ff=0).
"""
from repro_torch.configs.base import ModelConfig, register


@register("mamba2-370m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm", block_type="ssm",
        num_layers=48, d_model=1024, num_heads=1, num_kv_heads=1,
        head_dim=64, d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2,
        tie_embeddings=True, subquadratic=True)
