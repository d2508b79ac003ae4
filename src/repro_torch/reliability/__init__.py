"""Reliability layer: fault injection, ABFT verification, degradation
(counterpart of ``repro/reliability/``).

  :mod:`repro_torch.reliability.faults`   deterministic fault injection
                                          into programmed plan trees.
  :mod:`repro_torch.reliability.abft`     programming-time column
                                          checksums + execute-time
                                          verification, reported through
                                          the process-global FAULT_LOG.
  :mod:`repro_torch.reliability.degrade`  the serving engine's retry /
                                          re-program / degrade state
                                          machine.

The JAX package's trace-only names (``collected``, ``verified_scan``, its
jit-keyed ``CollectScope``) have no counterpart; ``collect_scope`` is the
one collection scope, opened by the serving engine around each dispatch.
"""
from repro_torch.reliability.abft import (FAULT_LOG, ChecksumViolation,
                                          CollectScope, FaultLog,
                                          VERIFY_MODES, checksums,
                                          collect_scope, deliver,
                                          raise_if_violations)
from repro_torch.reliability.degrade import (ReliabilityManager,
                                             ReliabilityPolicy,
                                             retarget_plans)
from repro_torch.reliability.faults import (FaultModel, dump_fault_spec,
                                            inject_dense, inject_tree,
                                            load_fault_spec, summarize)

__all__ = [
    "FAULT_LOG",
    "ChecksumViolation",
    "CollectScope",
    "FaultLog",
    "FaultModel",
    "ReliabilityManager",
    "ReliabilityPolicy",
    "VERIFY_MODES",
    "checksums",
    "collect_scope",
    "deliver",
    "dump_fault_spec",
    "inject_dense",
    "inject_tree",
    "load_fault_spec",
    "raise_if_violations",
    "retarget_plans",
    "summarize",
]
