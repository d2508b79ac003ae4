"""whisper-medium [audio]: 24L encoder + 24L decoder, d_model=1024 16H
(MHA kv=16, head_dim 64) d_ff=4096 vocab=51865 — enc-dec with
cross-attention; the conv audio frontend is a STUB (input_specs() provides
precomputed frame embeddings at d_model) [arXiv:2212.04356].

Shape convention: seq_len splits evenly between encoder frames and decoder
tokens for train/prefill; decode shapes attend over a seq_len/2 self cache
+ seq_len/2 cross cache. long_500k is skipped (full attention, DESIGN §4).
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio", block_type="attn",
        num_layers=24, encoder_layers=24, d_model=1024, num_heads=16,
        num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=51865,
        activation="gelu", gated_mlp=False, rope_theta=1e4,
        tie_embeddings=True)
