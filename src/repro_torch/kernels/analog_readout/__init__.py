"""The analog readout chain: CUDA kernel wrappers for the two passes,
their plain versions, and the device-dispatching public entry point."""
