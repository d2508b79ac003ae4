"""Static analysis + runtime sanitizers for the port's hot-path
invariants (counterpart of :mod:`repro.analysis`).

What the serving numbers rest on (no blocking host read in the decode
step, each step running at one input signature, tensors held only in
structures the tree walkers know, kernel entry points fed checked
memory, no silent fallback to the plain versions, the JAX substrate
names kept at their resolution site) is enforced mechanically here:

  lint.py       AST lint framework: ``Finding``, the string-keyed
                checker registry, inline suppressions, ``lint_paths``.
  callgraph.py  Project-wide call graph; computes the *hot set* (every
                function upstream or downstream of ``lm.decode_step``,
                ``ContinuousScheduler.run``, ``ServingEngine.generate`` /
                ``prefill_step``, ``engine.matmul``).
  checkers.py   The port's checkers (RPR1xx host reads, RPR2xx
                compile hazards, RPR301 tree walkers, RPR4xx kernel
                boundaries and fallbacks, RPR501 substrate aliases).
  sanitize.py   Runtime layer: ``Sanitizer`` (a host-read guard around
                each decode step call: CUDA's sync debug mode on the
                card, a TorchFunctionMode on the CPU; optional NaN
                checks) and ``CompileCounter`` (new step signatures and
                ``nvcc`` builds, per name).
  trace.py      In-process spans and counters at the program's layer
                boundaries (``span``, ``fine``, ``count``), recorded by
                an armed ``Recorder`` and mirrored onto a running
                ``torch.profiler``'s timeline; the one registry of armed
                consumers (the compile counter reads a recorder).
  cli.py        ``python -m repro_torch.analysis`` entry point; chains
                ruff when it is installed.

This module (and the lint machinery) imports no torch, so the lint pass
runs on a bare Python install; import
:mod:`repro_torch.analysis.sanitize` or :mod:`repro_torch.analysis.trace`
explicitly for the runtime layer.
"""
from repro_torch.analysis.lint import (Checker, Finding, available_checkers,
                                       get_checker, lint_paths, lint_source,
                                       register_checker)

__all__ = [
    "Checker",
    "Finding",
    "available_checkers",
    "get_checker",
    "lint_paths",
    "lint_source",
    "register_checker",
]
