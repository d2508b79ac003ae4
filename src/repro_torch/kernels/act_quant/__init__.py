"""The fused activation quantizer: float32 or bfloat16 rows on the card to
per-row scales and int8 nibble planes in one launch. Its plain version is
the eager path of ``repro_torch.core.pim._quantize_plain``."""
