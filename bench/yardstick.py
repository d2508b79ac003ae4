"""The benchmark's yardstick: published peaks, the roofline bound, tails,
spreads, busy time and the operation counts of the two model families.

Everything here is frozen with the benchmark: programs under test may
change, the arithmetic that judges them may not. Nothing here imports the
program.

Peaks: one NVIDIA H100 SXM (NVIDIA's H100 Tensor Core GPU data sheet,
dense rates without sparsity, at the full 700 W power limit): 3.35 TB/s
of HBM3, 1,979 TOP/s int8 on the tensor cores, 67 TFLOP/s float32 outside
them, 495 TFLOP/s TF32. The same constants as the repository's
``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``INT8_OPS_PER_S``,
``FP32_OPS_PER_S``, ``TF32_OPS_PER_S``), copied here.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12


def bound(pa: int, pw: int, m: int, k: int, n: int, out_bytes: int,
          extra_bytes: int) -> Tuple[float, str]:
    """Least time (s) of one bit-sliced matmul launch: (Pa, M, K) int8
    activation planes against (Pw, K, N) int8 weight planes, an (M, N)
    output of ``out_bytes`` a value, ``extra_bytes`` of scales and bias.
    Each input read once and each output written once against HBM
    bandwidth; 2 * Pa * Pw * M * K * N int8 operations against the tensor
    cores' peak. Returns (seconds, "bytes" | "operations"). The
    arithmetic of ``chip_smoke.bound``, in seconds."""
    moved = pa * m * k + pw * k * n + out_bytes * m * n + extra_bytes
    ops = 2.0 * pa * pw * m * k * n
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def fused_launch_bound(a_shape: Sequence[int], w_shape: Sequence[int],
                       has_bias: bool) -> float:
    """:func:`bound` of one fused launch from its operands' shapes as the
    kernel takes them: activation planes (Pa, M, K), weight planes (Pw,
    K, N); a float32 (M, N) output, float32 scales (M and N) and bias
    (N)."""
    pa, m, k = a_shape
    pw, k2, n = w_shape
    if k2 < k:
        raise ValueError(f"weight planes {tuple(w_shape)} shorter than the "
                         f"activation planes {tuple(a_shape)}")
    extra = 4 * m + 4 * n + (4 * n if has_bias else 0)
    return bound(pa, pw, m, k2, n, 4, extra)[0]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) with linear interpolation between
    order statistics (numpy's default), computed without numpy."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median, with the quartiles of ``statistics.quantiles(values, n=4)``:
    the benchmark's measure of run-to-run noise."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


class HostWindow:
    """The measured window on the host clock less the profiled stretch
    (``stretch``, (start, end) or None): where the per-layer host-clock
    and counter readings are taken, so that the profiler's own host time
    stays out of them."""

    def __init__(self, open_s: float, close_s: float,
                 stretch: Optional[Sequence[float]] = None):
        self.open, self.close = open_s, close_s
        self.stretch = None if stretch is None else (
            max(stretch[0], open_s), min(stretch[1], close_s))

    def holds(self, t: float) -> bool:
        if not self.open <= t <= self.close:
            return False
        return self.stretch is None or not (
            self.stretch[0] <= t <= self.stretch[1])

    @property
    def seconds(self) -> float:
        out = self.close - self.open
        if self.stretch is not None and self.stretch[1] > self.stretch[0]:
            out -= self.stretch[1] - self.stretch[0]
        return out


def merge_spans(spans: Iterable[Tuple[float, float]]
                ) -> List[Tuple[float, float]]:
    """Union of (start, end) intervals, as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_time(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of intervals (the device's busy time)."""
    return sum(e - s for s, e in merge_spans(spans))


def idle_gaps(spans: Iterable[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """The gaps between the union's intervals, as (start, end)."""
    merged = merge_spans(spans)
    return [(a[1], b[0]) for a, b in zip(merged, merged[1:])]


# ---------------------------------------------------------------------------
# operation counts from shapes
# ---------------------------------------------------------------------------
def conv_out(hw: int, stride: int) -> int:
    """SAME-padded output size."""
    return (hw + stride - 1) // stride


def cnn_macs(layers: Sequence[Dict]) -> int:
    """Multiply-accumulates of one image through a layer table (the
    benchmark's own, see :func:`bench.reference.cnn.layer_table`)."""
    total = 0
    for l in layers:
        if l["kind"] == "conv":
            oh = conv_out(l["in_hw"], l["stride"])
            total += oh * oh * l["out_c"] * l["k"] * l["k"] * l["in_c"]
        else:
            total += l["in_f"] * l["out_f"]
    return total


def cnn_weights(layers: Sequence[Dict]) -> int:
    """Weights of a layer table (biases not counted)."""
    total = 0
    for l in layers:
        if l["kind"] == "conv":
            total += l["k"] * l["k"] * l["in_c"] * l["out_c"]
        else:
            total += l["in_f"] * l["out_f"]
    return total


def lm_projection_ops(model: Dict) -> float:
    """Operations of one token through every layer's projections (q, k,
    v, o and the gated MLP), 2 per multiply-accumulate."""
    d, h, kv, hd, ff = (model["hidden_size"], model["num_attention_heads"],
                        model["num_key_value_heads"], model["head_dim"],
                        model["intermediate_size"])
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff
    return 2.0 * per_layer * model["num_hidden_layers"]


def lm_attention_ops(model: Dict, keys: int) -> float:
    """Operations of one query over ``keys`` positions through every
    layer's attention: scores and the weighted sum of values, 2 per
    multiply-accumulate each."""
    return (4.0 * model["num_attention_heads"] * model["head_dim"] * keys
            * model["num_hidden_layers"])


def lm_unembed_ops(model: Dict) -> float:
    """Operations of one row's logits over the vocabulary."""
    return 2.0 * model["hidden_size"] * model["vocab_size"]


def lm_prefill_ops(model: Dict, prompt: int) -> float:
    """A prompt's useful work: every position through the projections,
    causal attention (position p sees p + 1 keys), one row of logits."""
    attn = lm_attention_ops(model, 1) * prompt * (prompt + 1) / 2.0
    return lm_projection_ops(model) * prompt + attn + lm_unembed_ops(model)


def lm_decode_ops(model: Dict, position: int) -> float:
    """One generated token's work at cache position ``position``."""
    return (lm_projection_ops(model) + lm_attention_ops(model, position + 1)
            + lm_unembed_ops(model))


def share(numerator: Optional[float], denominator: Optional[float]
          ) -> Optional[float]:
    """numerator / denominator in percent, or None where either is
    missing or the denominator is not positive."""
    if numerator is None or denominator is None or denominator <= 0:
        return None
    return 100.0 * numerator / denominator
