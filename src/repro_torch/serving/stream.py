"""Completion records and streaming callbacks for the serving subsystem
(counterpart of ``repro/serving/stream.py``; plain Python and numpy).

The scheduler reports progress through a :class:`StreamCallbacks` object:
``on_admit`` when a request wins a slot (its first token exists at that
point — prefill produces it), ``on_token`` per generated token, and
``on_finish`` with the full :class:`Completion` record. Times are in
scheduler steps (the virtual clock: one decode step == 1.0) so traces are
deterministic; wall-clock aggregates live in the scheduler's metrics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List

import numpy as np


@dataclasses.dataclass
class Completion:
    """One finished request, with its per-request latency accounting."""

    request_id: Hashable
    prompt: np.ndarray           # (prompt_len,) int32 prompt tokens
    tokens: np.ndarray           # (<= max_new_tokens,) int32 generated tokens
    arrival_step: float          # virtual time the request arrived
    admit_step: float            # virtual time it won a slot (prefill ran)
    finish_step: float           # virtual time its last token was produced
    slot: int                    # slot it occupied (diagnostics)
    # why generation ended: the trace budget ran out ("budget"), the
    # model emitted its EOS token ("eos"), a user stop token
    # ("stop_token"), or the request's virtual-clock deadline passed
    # ("deadline" — tokens holds whatever was produced in time; empty if
    # the request never won a slot). For token stops, the stop token
    # itself is the last entry of ``tokens``; nothing is emitted after.
    stop_reason: str = "budget"
    # wall-clock marks relative to the run start (seconds). The virtual
    # clock stays the unit of latency *accounting*; these feed the
    # decode microbenchmark's chunked-vs-unchunked TTFT comparison,
    # which is about real prefill stalls, not scheduling policy.
    first_token_wall_s: float = 0.0
    finish_wall_s: float = 0.0

    @property
    def ttft_steps(self) -> float:
        """Time to first token: prefill runs at admission, so this is the
        queueing delay plus the admission step itself."""
        return self.admit_step - self.arrival_step

    @property
    def latency_steps(self) -> float:
        return self.finish_step - self.arrival_step


class StreamCallbacks:
    """No-op base; override any subset. All hooks run host-side inside
    the scheduler loop — keep them cheap."""

    def on_admit(self, request_id: Hashable, slot: int, step: float) -> None:
        pass

    def on_token(self, request_id: Hashable, token: int, index: int) -> None:
        """``index`` is the position of the token within the generated
        sequence (0 = the prefill-produced first token)."""

    def on_finish(self, completion: Completion) -> None:
        pass


class TokenCollector(StreamCallbacks):
    """Callback that gathers streamed tokens and completions (the default
    sink; also what the invariant tests inspect — every request must
    finish exactly once and its streamed tokens must equal the completion
    record)."""

    def __init__(self) -> None:
        self.streamed: Dict[Hashable, List[int]] = {}
        self.completions: List[Completion] = []

    def on_token(self, request_id: Hashable, token: int, index: int) -> None:
        self.streamed.setdefault(request_id, []).append(int(token))

    def on_finish(self, completion: Completion) -> None:
        self.completions.append(completion)
