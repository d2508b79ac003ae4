"""The bit-sliced PIM matmul: CUDA kernel wrappers, plain versions, and
the device-dispatching public entry points."""
