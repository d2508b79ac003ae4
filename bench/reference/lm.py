"""Plain reference of the decoder-only LM configurations (Qwen3-style:
GQA with qk-norm and RoPE over half-split head dimensions, RMS norms, a
SiLU-gated MLP, a tied embedding table), with the configuration's
numerics, written from the configuration alone.

Numerics stated by the configuration: every attention and MLP projection
at w4a4 (:mod:`bench.reference.quant`), float32 elsewhere; the tied table
fake-quantized per column; the KV cache in bfloat16. A served request is
a prompt, prefilled whole (float32 keys and values, one exact softmax),
then one token at a time through the cache: a decode position reads every
key and value in the cache's dtype, its probabilities are taken in that
dtype and so is the attention's output, whose projection returns in its
input's dtype (the JAX package's semantics for a bf16 cache).

The reference is applied stage by stage (:meth:`Reference.attention`,
:meth:`Reference.mlp`, :meth:`Reference.logits`): each stage takes the
residual stream a request's rows carry into it and returns what they
carry out. Chained from :meth:`Reference.embed`, the stages are the whole
model; the benchmark's check feeds each stage the program's own input
instead, because w4a4 requantizes every projection's input, so a
rounding-sized difference flips activation codes and the flips grow
through 36 layers into a different greedy continuation.

Weights are drawn from the seed on the device: the table, then each
layer in one normal draw, in a fixed order that the program's set-up and
the reference share (:func:`draw_table`, :func:`draw_layer`).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator

import torch
import torch.nn.functional as F

from bench.reference.quant import QuantWeight, fake_quantize, qmatmul

NEG_INF = -1e30
# (name, input size key, output size) of one layer's projections, in draw
# order; sizes from the model dict
_PROJ = (("wq", "d", "q"), ("wk", "d", "kv"), ("wv", "d", "kv"),
         ("wo", "q", "d"), ("wi", "d", "ff"), ("wg", "d", "ff"),
         ("wd", "ff", "d"))


def padded_vocab(model: Dict) -> int:
    """Rows of the drawn table: the vocabulary padded to a multiple of
    256 (the padded rows' logits are masked; their values enter the
    table's per-column scales)."""
    return (model["vocab_size"] + 255) // 256 * 256


def _dims(model: Dict) -> Dict[str, int]:
    return {"d": model["hidden_size"],
            "q": model["num_attention_heads"] * model["head_dim"],
            "kv": model["num_key_value_heads"] * model["head_dim"],
            "ff": model["intermediate_size"]}


def draw_table(gen: torch.Generator, model: Dict, device) -> torch.Tensor:
    """The (padded vocab, hidden) embedding table, N(0, 0.02^2)."""
    return torch.randn((padded_vocab(model), model["hidden_size"]),
                       generator=gen, device=device) * 0.02


def draw_layer(gen: torch.Generator, model: Dict, device
               ) -> Dict[str, torch.Tensor]:
    """One layer's projections as (in, out) float32 matrices, each
    N(0, 1/in), from one normal draw."""
    dims = _dims(model)
    sizes = [dims[i] * dims[o] for _, i, o in _PROJ]
    flat = torch.randn((sum(sizes),), generator=gen, device=device)
    out, at = {}, 0
    for (name, i, o), n in zip(_PROJ, sizes):
        out[name] = flat[at:at + n].reshape(dims[i], dims[o]) \
            / math.sqrt(dims[i])
        at += n
    return out


def rms_norm(x: torch.Tensor, eps: float, by_sum: bool = False
             ) -> torch.Tensor:
    """RMS norm with a unit weight, in float32, returned in x's dtype;
    ``by_sum`` takes the mean square as a sum over the width (another
    rounding, read as a sound variant)."""
    dt = x.dtype
    x = x.to(torch.float32)
    ms = (torch.sum(x * x, dim=-1, keepdim=True) / x.shape[-1] if by_sum
          else torch.mean(x * x, dim=-1, keepdim=True))
    x = x * torch.rsqrt(ms + eps)
    return x.to(dt)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, hd) at positions 0..T-1; the head dimension split in
    halves."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = torch.arange(x.shape[0], device=x.device,
                       dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_pos: torch.Tensor, probs_dtype) -> torch.Tensor:
    """Queries q (S, H, hd) at positions ``q_pos`` over keys/values (T,
    KV, hd) at 0..T-1, causal, one softmax; logits in float32 (or q's
    dtype if lower), probabilities in ``probs_dtype``, output in v's
    dtype."""
    s, h, hd = q.shape
    kvh = k.shape[1]
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(s, kvh, h // kvh, hd).to(dt)
    logits = torch.einsum("skrd,tkd->krst", qg, k.to(dt))
    if dt != torch.bfloat16:
        logits = logits.to(torch.float32)
    logits = logits / math.sqrt(hd)
    ok = torch.arange(k.shape[0], device=q.device)[None, :] \
        <= q_pos[:, None]
    logits = torch.where(ok[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(probs_dtype)
    out = torch.einsum("krst,tkd->skrd", probs, v.to(probs_dtype))
    return out.reshape(s, h * hd)


class Reference:
    """The reference's stages for one seed's weights. ``dtype`` float32
    is the configuration's numerics; bfloat16 (the control) holds every
    float tensor and product in bfloat16. ``table_scale`` multiplies the
    drawn table and ``norm_by_sum`` takes every RMS norm's mean square as
    a sum (rounding-sized changes, read as sound variants when the limits
    are set)."""

    def __init__(self, model: Dict, bits: Dict[str, int], seed: int,
                 device, dtype=torch.float32, cache_dtype=torch.bfloat16,
                 table_scale: float = 1.0, norm_by_sum: bool = False):
        self.model, self.bits, self.seed = model, bits, seed
        self.device, self.dtype, self.cache_dtype = device, dtype, cache_dtype
        self.table_scale = table_scale
        self.eps = model["rms_norm_eps"]
        self.norm = lambda x: rms_norm(x, self.eps, norm_by_sum)
        gen = torch.Generator(device=device).manual_seed(seed)
        table = draw_table(gen, model, device) * table_scale
        self.table = fake_quantize(table, bits["weight"], dim=0)[
            :model["vocab_size"]].to(dtype)

    def layers(self) -> Iterator[Dict[str, QuantWeight]]:
        """Each layer's quantized projections, drawn in order."""
        m, dev = self.model, self.device
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        draw_table(gen, m, dev)
        for _ in range(m["num_hidden_layers"]):
            raw = draw_layer(gen, m, dev)
            yield {k: QuantWeight(v, self.bits["weight"]).to(self.dtype)
                   for k, v in raw.items()}
            del raw

    def _proj(self, a, w, out_dtype=None):
        return qmatmul(a, w, self.bits["act"], out_dtype=out_dtype
                       or self.dtype)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The rows that enter the first layer."""
        return self.table[tokens]

    def attention(self, x: torch.Tensor, w: Dict[str, QuantWeight],
                  prompt: int) -> torch.Tensor:
        """One request's rows (T, hidden) through a layer's attention
        block, residual added: rows 0..prompt-1 are the prefilled prompt,
        the rest are decoded one at a time through the cache."""
        m, dt = self.model, self.dtype
        low = dt == torch.bfloat16
        h, kvh, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                      m["head_dim"])
        theta = m["rope_theta"]
        x = x.to(dt)
        t, p = x.shape[0], prompt
        hn = self.norm(x)
        q, k, v = (self._proj(hn, w["wq"]), self._proj(hn, w["wk"]),
                   self._proj(hn, w["wv"]))
        qr = rope(self.norm(q.reshape(t, h, hd)), theta)
        kr = rope(self.norm(k.reshape(t, kvh, hd)), theta)
        vr = v.reshape(t, kvh, hd)
        pos = torch.arange(t, device=x.device)
        out = torch.empty_like(x)
        pre = _attend(qr[:p], kr[:p], vr[:p], pos[:p], dt)
        out[:p] = self._proj(pre, w["wo"])
        if t > p:
            cd = dt if low else self.cache_dtype
            dec = _attend(qr[p:], kr.to(cd), vr.to(cd), pos[p:], cd)
            out[p:] = self._proj(dec, w["wo"], out_dtype=cd).to(dt)
        return x + out

    def mlp(self, x: torch.Tensor, w: Dict[str, QuantWeight]
            ) -> torch.Tensor:
        """Rows (any number, each on its own) through a layer's MLP,
        residual added."""
        x = x.to(self.dtype)
        hn = self.norm(x)
        gate = F.silu(self._proj(hn, w["wg"])) * self._proj(hn, w["wi"])
        return x + self._proj(gate, w["wd"])

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Float32 logits of the rows that leave the last layer."""
        return (self.norm(x.to(self.dtype)) @ self.table.T).to(
            torch.float32)

    def forward(self, tokens: torch.Tensor, prompt: int) -> torch.Tensor:
        """The stages chained over one request's tokens (the prompt, then
        the served tokens but the last): its logits at every row."""
        x = self.embed(tokens)
        for w in self.layers():
            x = self.mlp(self.attention(x, w, prompt), w)
        return self.logits(x)


def stage_error(got: torch.Tensor, want: torch.Tensor,
                before: torch.Tensor) -> float:
    """How far a stage's output ``got`` lies from the reference's
    ``want`` (both from the same input ``before``): the norm of their
    difference over the norm of what the stage added, over all rows."""
    got, want, before = (a.to(torch.float32) for a in (got, want, before))
    added = float(torch.linalg.vector_norm(want - before))
    diff = float(torch.linalg.vector_norm(got - want))
    return diff / added if added > 0 else (0.0 if diff == 0 else math.inf)


def served_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
    """At each row, the gap by which the served token's reference logit
    lies below the reference's best."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, tokens.reshape(-1, 1).to(
        ref_logits.device))[:, 0]
    return best - got
