"""Masked GQA flash attention: the CUDA kernel wrapper (forward and
backward, with an autograd Function), its plain version, and the
device-dispatching public entry point."""
