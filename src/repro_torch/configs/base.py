"""Model configuration schema + registry for the assigned architectures.

Copied from ``repro/configs/base.py`` (the port imports nothing of the
JAX package). ``attn_backend`` names the training attention route:
``"jnp"`` (plain PyTorch, the default, as in JAX) or ``"cuda"`` (the
hand-written flash-attention kernel, forward and backward), with the JAX
names ``"pallas"`` and ``"pallas_interp"`` accepted as aliases of
``"cuda"``. ``ssd_backend`` names the SSD scan route:
``"chunked"`` and ``"sequential"`` (plain PyTorch) or ``"cuda"`` (the
hand-written kernel), with the JAX names ``"pallas"`` and
``"pallas_interp"`` accepted as aliases of ``"cuda"``."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0          # 0 = all-global attention
    global_every: int = 0            # >0: every Nth layer is global (gemma3)
    attn_logit_softcap: float = 0.0

    # mixer selection
    block_type: str = "attn"         # attn | ssm | hybrid

    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    shared_experts: int = 0

    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1

    # structure
    encoder_layers: int = 0          # >0: encoder-decoder (whisper)
    vision_tokens: int = 0           # >0: VLM prefix patches (paligemma)
    vision_dim: int = 0              # stub patch-embedding dim
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    activation: str = "silu"
    gated_mlp: bool = True

    # execution
    remat: bool = False
    unroll_layers: bool = False   # unroll scan-over-layers (cost analysis)
    attn_backend: str = "jnp"        # jnp | cuda (pallas, pallas_interp)
    attn_block: int = 512            # blockwise-attention KV chunk
    blockwise_threshold: int = 2048  # switch to blockwise above this seq len
    ssd_chunk: int = 128
    ssd_backend: str = "chunked"     # chunked | sequential | cuda

    # which serve/long-context shapes apply (DESIGN.md §4)
    subquadratic: bool = False       # runs long_500k
    has_decoder: bool = True

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded to a 256 multiple so the vocab axis
        shards evenly (standard practice); logits beyond vocab_size are
        masked to -inf."""
        return ((self.vocab_size + 255) // 256) * 256

    def layer_window(self, i: int) -> int:
        """Sliding window for layer i (0 = global)."""
        if self.sliding_window == 0:
            return 0
        if self.global_every and (i + 1) % self.global_every == 0:
            return 0
        return self.sliding_window

    def reduced(self, num_layers: int = 2, d_model: int = 64,
                vocab: int = 128) -> "ModelConfig":
        """Smoke-test configuration of the same family (small everything)."""
        scale = d_model / self.d_model
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        head_dim = max(8, d_model // heads)
        enc = min(self.encoder_layers, num_layers) if self.encoder_layers \
            else 0
        return dataclasses.replace(
            self, num_layers=num_layers, d_model=d_model, num_heads=heads,
            num_kv_heads=kv, head_dim=head_dim,
            d_ff=max(16, int(self.d_ff * scale)) if self.d_ff else 0,
            vocab_size=vocab,
            num_experts=min(self.num_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=max(8, int(self.moe_d_ff * scale)) if self.moe_d_ff
            else 0,
            shared_experts=min(self.shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            encoder_layers=enc,
            vision_tokens=min(self.vision_tokens, 16),
            vision_dim=min(self.vision_dim, 32) if self.vision_dim else 0,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window
            else 0,
            attn_block=64, blockwise_threshold=256, ssd_chunk=16)


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        # import config modules lazily to populate the registry
        import repro_torch.configs.archs  # noqa: F401
        if arch_id not in _REGISTRY:
            raise KeyError(f"unknown arch '{arch_id}'; known: "
                           f"{sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs():
    import repro_torch.configs.archs  # noqa: F401
    return sorted(_REGISTRY)
