"""Quantization: symmetric codes and scales, nibble planes."""
