"""The chunked Mamba2 SSD scan: the CUDA kernel wrapper, its plain
versions, and the device-dispatching public entry point."""
