"""Import all architecture configs to populate the registry."""
from repro_torch.configs import (gemma3_1b, granite_20b,  # noqa: F401
                           hymba_1_5b, mamba2_370m, moonshot_v1_16b_a3b,
                           paligemma_3b, qwen2_5_3b, qwen3_4b,
                           qwen3_moe_30b_a3b, whisper_medium)

ARCH_IDS = [
    "hymba-1.5b", "mamba2-370m", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b",
    "paligemma-3b", "qwen3-4b", "granite-20b", "gemma3-1b", "qwen2.5-3b",
    "whisper-medium",
]
