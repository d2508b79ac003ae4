"""Continuous-batching serving subsystem over the weight-stationary PIM
engine (counterpart of ``repro/serving``).

The engine programs weights once (``engine.program``) and amortizes them
over traffic (``engine.matmul``); this package supplies the traffic
shape that makes the amortization pay: a JetStream-style serving engine
(prefill / insert / generate) plus a request scheduler that admits
heterogeneous arrivals into a fixed pool of decode slots, interleaves
(optionally chunked) prefill with in-flight decode, and refills retired
slots immediately — all at fixed step shapes.

  slots.py      SlotAllocator + slot-indexed KV cache (masked prefill
                write, per-slot sequence offsets)
  engine.py     ServingEngine facade: prefill/insert/generate verbs,
                on-device stop detection, chunked prefill, masked decode
                windows; DecodeState, PrefillTask, StepResult
  prefix.py     content-hashed shared-prefix KV cache (PrefixCache)
  scheduler.py  ContinuousScheduler (admission, step loop, latency/TTFT
                accounting), Request, poisson_trace, static_generate
  stream.py     Completion records and streaming callbacks
"""
from repro_torch.serving.engine import (DecodeState, PrefillTask,
                                        ServingEngine, SlotView, StepResult,
                                        TokenEvent)
from repro_torch.serving.prefix import (Prefix, PrefixCache, PrefixEntry,
                                        token_key)
from repro_torch.serving.scheduler import (ContinuousScheduler, Request,
                                           RunResult, poisson_trace,
                                           static_generate)
from repro_torch.serving.slots import (SlotAllocator, init_slot_cache,
                                       write_prefill)
from repro_torch.serving.stream import (Completion, StreamCallbacks,
                                        TokenCollector)

__all__ = [
    "Completion",
    "ContinuousScheduler",
    "DecodeState",
    "Prefix",
    "PrefixCache",
    "PrefixEntry",
    "PrefillTask",
    "Request",
    "RunResult",
    "ServingEngine",
    "SlotAllocator",
    "SlotView",
    "StepResult",
    "StreamCallbacks",
    "TokenCollector",
    "TokenEvent",
    "init_slot_cache",
    "poisson_trace",
    "static_generate",
    "token_key",
    "write_prefill",
]
