"""PyTorch/CUDA port of the OPIMA weight-stationary PIM engine.

The package mirrors :mod:`repro` (the JAX reference) module for module:
``quant`` (codes, scales, nibble planes), ``core.pim`` (plans and the
exact / analog / emulation arithmetic), ``engine`` (the substrate
registry and the ``program`` / ``matmul`` verbs), ``models.cnn`` (the
Table-II CNN executor), ``configs`` and ``models.{layers, attention, ssm,
lm}`` (the LM stack for dense, SSM and hybrid models),
``launch.serve`` (static LM serving on the engine) and ``kernels``
(hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version).

Device rule: functions that create tensors take ``device=None``, which
means CUDA (and raises when no card is present); functions that take
tensors run where the tensors are. A kernel wrapper takes its plain
version only for a tensor on the CPU; on a CUDA tensor it launches the
kernel or raises.
"""
