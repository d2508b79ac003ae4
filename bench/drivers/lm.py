"""Driver of the decoder-only LM configurations: the program's
``serving.ContinuousScheduler.run`` (the path ``serve --continuous``
takes) over a closed loop of clients.

Set-up draws the weights from the seed on the device
(:mod:`bench.reference.lm`), programs each layer as it is drawn with the
program's ``launch.serve.plan_layer`` on the configuration's substrate,
fake-quantizes the tied table as ``launch/serve.py`` does, builds the
scheduler at the traffic's slot geometry and runs its warm-up.

The scheduler takes no request while it runs, so the loop is the
scheduler's own backlog: every request of the mix is queued at once (FIFO,
arrival 0), and with as many slots as clients the scheduler keeps exactly
``clients`` requests in the system, as the closed loop does. Request k is
taken to be sent when its client's previous request finished: at the
run's start for the first ``clients`` requests, else at the (k -
clients)-th completion. The window opens at the ``warm``-th completion,
once the loop runs in step, and closes ``--seconds`` later; the harness's
callback stops the run at its first event after the close once the
requests the check follows whole have finished (the requests in flight
then are not counted).

The check follows the program step by step (:class:`Capture`): w4a4
requantizes every projection's input, so a rounding-sized change flips
activation codes and, through 36 layers, gives another greedy
continuation; the program's tokens cannot be judged against a reference
run on its own. So each stage is judged from the program's own input
(PERF.md, section 2): the first layer's input against the reference's
embedding, each layer's attention and MLP block against the reference's
given the rows the program fed it, and each served token against the
reference's logits of the program's last residual rows.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bench import traffic as traffic_mod
from bench import yardstick
from bench.reference import lm as ref

# the program's functions the capture wraps
LM_MODULE = "repro_torch.models.lm"
# rows of logits the reference computes at once
LOGIT_ROWS = 256
# decode steps whose streams one preallocated block of the capture holds
DECODE_BLOCK = 64


class WindowClosed(Exception):
    """Raised from a scheduler callback at the first event after the
    window's close."""


def port_config(name: str, model: Dict, **overrides):
    """The benchmark's model dict as the program's ``ModelConfig`` (the
    program's own attention defaults unless ``overrides`` set them)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=name, family="dense", block_type="attn",
        num_layers=model["num_hidden_layers"],
        d_model=model["hidden_size"],
        num_heads=model["num_attention_heads"],
        num_kv_heads=model["num_key_value_heads"],
        head_dim=model["head_dim"], d_ff=model["intermediate_size"],
        vocab_size=model["vocab_size"], qk_norm=True,
        rope_theta=float(model["rope_theta"]),
        tie_embeddings=model["tie_word_embeddings"],
        norm_eps=model["rms_norm_eps"], **overrides)


def port_layer(w: Dict[str, torch.Tensor], model: Dict, device) -> Dict:
    """One drawn layer as the program's parameter tree (norm weights
    zero: the unit scale of ``rms_norm``'s ``1 + weight``)."""
    z = lambda n: torch.zeros((n,), device=device)
    d, hd = model["hidden_size"], model["head_dim"]
    return {"ln1_d": z(d),
            "attn": {"wq_dh": w["wq"], "wk_dh": w["wk"], "wv_dh": w["wv"],
                     "wo_hd": w["wo"], "qnorm_d": z(hd), "knorm_d": z(hd)},
            "ln2_d": z(d),
            "mlp": {"wi_dh": w["wi"], "wg_dh": w["wg"], "wo_hd": w["wd"]}}


class Capture:
    """The program's residual stream, read where its forward normalizes
    it: in ``models.lm.prefill`` and ``models.lm.decode_step`` each
    layer's two ``rms_norm`` calls take the layer's input and its input to
    the MLP, and the final one takes the last layer's output, so one
    forward makes ``2 * layers + 1`` calls (stream j = 0..2L: stage j maps
    stream j to stream j + 1, attention for even j, MLP for odd j). The
    prefills' tensors are held, not copied (the forward makes a new
    residual at each add); a decode step's are copied, in one launch, into
    a block allocated ``DECODE_BLOCK`` steps at a time, so the program's
    own tensors are freed and reused as they are without the capture.
    Kept: every stream of the prefills of the requests in ``full``; the
    last stream's row that chose the first token of every other prefill;
    every stream of every decode step, with the slots occupied then."""

    def __init__(self, engine, layers: int, rid_of: Dict[int, str],
                 full, slots: Dict[int, str]):
        self.engine, self.calls = engine, 2 * layers + 1
        self.rid_of, self.full, self.slots = rid_of, set(full), slots
        self.prefills: Dict[str, List[torch.Tensor]] = {}
        self.finals: Dict[str, torch.Tensor] = {}
        self.decodes: List[Tuple[Dict[int, str], torch.Tensor,
                                 torch.Tensor, List[torch.Tensor]]] = []
        self.faults: List[str] = []
        self._into: Optional[List[torch.Tensor]] = None
        self._rid: Optional[str] = None
        self._saved: List = []
        self._block: Optional[torch.Tensor] = None
        self._used = 0

    def _keep(self, xs: List[torch.Tensor]):
        """A decode step's streams, copied into the current block."""
        if len(xs) != self.calls:
            return xs
        if self._block is None or self._used == self._block.shape[0]:
            self._block = torch.empty(
                (DECODE_BLOCK, len(xs)) + tuple(xs[0].shape),
                dtype=xs[0].dtype, device=xs[0].device)
            self._used = 0
        out = self._block[self._used]
        self._used += 1
        torch.stack(xs, out=out)
        return out

    def install(self) -> None:
        import importlib
        lm = importlib.import_module(LM_MODULE)
        norm, prefill, decode = lm.rms_norm, lm.prefill, lm.decode_step
        start = self.engine.start_prefill

        def rms_norm(x, *args, **kwargs):
            if self._into is not None:
                self._into.append(x)
            return norm(x, *args, **kwargs)

        def run(fn, *args, **kwargs):
            self._into = xs = []
            try:
                out = fn(*args, **kwargs)
            finally:
                self._into = None
            if len(xs) != self.calls:
                self.faults.append(f"{fn.__name__} normalized the residual "
                                   f"{len(xs)} times, not {self.calls}")
            return out, xs

        def prefill_rows(params, cfg, batch, max_len, *args, **kwargs):
            out, xs = run(prefill, params, cfg, batch, max_len, *args,
                          **kwargs)
            plen = kwargs["logits_index"] + 1
            if self._rid in self.full:
                self.prefills[self._rid] = [x[0, :plen] for x in xs]
            elif xs:
                self.finals[self._rid] = xs[-1][0, plen - 1].clone()
            return out

        def decode_rows(params, cfg, cache, token, index):
            out, xs = run(decode, params, cfg, cache, token, index)
            self.decodes.append((dict(self.slots), token, index,
                                 self._keep(xs)))
            return out

        def start_prefill(tokens, *args, **kwargs):
            self._rid = self.rid_of.get(id(tokens))
            return start(tokens, *args, **kwargs)

        for name, fn in (("rms_norm", rms_norm), ("prefill", prefill_rows),
                         ("decode_step", decode_rows)):
            self._saved.append((lm, name, getattr(lm, name)))
            setattr(lm, name, fn)
        self.engine.start_prefill = start_prefill

    def remove(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()
        self.engine.__dict__.pop("start_prefill", None)

    def decode_rows(self) -> Dict[Tuple[str, int], Tuple[int, int]]:
        """(request, position) -> (decode step, slot) of every occupied
        row of the decode steps."""
        if not self.decodes:
            return {}
        pos = torch.stack([d[2] for d in self.decodes]).cpu().numpy()
        out = {}
        for i, (slots, _, _, _) in enumerate(self.decodes):
            for slot, rid in slots.items():
                out.setdefault((rid, int(pos[i, slot])), (i, slot))
        return out


class _Loop:
    """The scheduler's callbacks: times every event on the host clock,
    tracks the slots, opens and closes the window, starts and stops the
    traced stretch."""

    def __init__(self, clients: int, warm: int, seconds: float, tracer,
                 trace_requests: int, rids: List[str], follow):
        self.clients, self.warm, self.seconds = clients, warm, seconds
        self.tracer, self.rids, self.follow = tracer, rids, set(follow)
        self.index = {r: i for i, r in enumerate(rids)}
        self.open = self.close = None
        self.stretch: Optional[List[float]] = None
        self.first: Dict[str, float] = {}          # first token on the host
        self.tokens: List[Tuple[float, str, int]] = []
        self.finished: List[Tuple[float, str, np.ndarray]] = []
        self.done = set()
        self.slots: Dict[int, str] = {}
        self.traced = set()
        self.trace_requests = trace_requests
        self.run_start = time.perf_counter()

    def send_time(self, k: int) -> float:
        if k < self.clients:
            return self.run_start
        return self.finished[k - self.clients][0]

    def _after(self, t: float) -> None:
        if self.close is None or t < self.close:
            return
        # the followed requests finish first; a minute past the close
        # the check finds whichever did not
        if self.follow <= self.done or t >= self.close + 60.0:
            raise WindowClosed

    def on_admit(self, rid, slot, step) -> None:
        t = time.perf_counter()
        self.first[rid] = t
        self.slots[slot] = rid
        self._after(t)

    def on_token(self, rid, token, index) -> None:
        t = time.perf_counter()
        self.tokens.append((t, rid, int(index)))
        self._after(t)

    def on_finish(self, comp) -> None:
        t = time.perf_counter()
        self.slots.pop(comp.slot, None)
        self.done.add(comp.request_id)
        self.finished.append((t, comp.request_id,
                              np.asarray(comp.tokens, np.int64)))
        self._after(t)
        if len(self.finished) == self.warm:
            self.open, self.close = t, t + self.seconds
            # the request sent at this completion opens the traced stretch
            first = self.warm - 1 + self.clients
            self.traced = {self.rids[k] for k in
                           range(first, first + self.trace_requests)
                           if k < len(self.rids)}
            if self.tracer.enabled:
                # the stretch holds the profiler's start and stop
                self.stretch = [time.perf_counter(), math.inf]
                self.tracer.start()
        elif comp.request_id in self.traced:
            self.traced.discard(comp.request_id)
            if not self.traced and self.stretch is not None:
                self.tracer.stop()
                self.stretch[1] = time.perf_counter()


class System:
    """The program under test for one run of an LM serving cell.
    ``overrides`` set fields of the program's model configuration (a
    sound variant read when the limits are set, such as another attention
    block)."""

    def __init__(self, cell, seed: int, device: str, log, t0: float,
                 **overrides):
        self.cell, self.seed, self.log, self.t0 = cell, seed, log, t0
        self.device = torch.device(device)
        self.model = cell.config["model"]
        self.traffic = cell.traffic
        self.overrides = overrides
        q = cell.config["quantization"]
        self.bits = {"weight": q["weight_bits"], "act": q["act_bits"]}

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core.pim import PimConfig
        from repro_torch.launch import serve as serve_mod
        from repro_torch.models.lm import stack_layers
        from repro_torch.quant.quantize import fake_quantize
        from repro_torch.serving import ContinuousScheduler, Request
        q = self.cell.config["quantization"]
        pim = PimConfig(weight_bits=q["weight_bits"], act_bits=q["act_bits"],
                        substrate=q["substrate"])
        m, dev = self.model, self.device
        self.cfg = port_config(self.cell.config["name"], m, **self.overrides)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        table = ref.draw_table(gen, m, dev)
        layers = []
        for _ in range(m["num_hidden_layers"]):
            layers.append(serve_mod.plan_layer(
                port_layer(ref.draw_layer(gen, m, dev), m, dev), pim,
                ("layers",)))
        self.params = {"embed_vd": fake_quantize(table, q["weight_bits"],
                                                 axis=(0,)),
                       "final_norm_d": torch.zeros((m["hidden_size"],),
                                                   device=dev),
                       "layers": stack_layers(layers)}
        del table, layers
        t = self.traffic
        pad = t["prompt_pad"]
        self.sched = ContinuousScheduler(
            self.params, self.cfg, num_slots=t["clients"], prompt_pad=pad,
            max_len=pad + t["output"]["hi"])
        self.sched.warmup()
        backlog = traffic_mod.lm_requests(t, m["vocab_size"], self.seed)
        self.rids = [f"{k:06d}" for k in range(len(backlog))]
        self.requests = [Request(request_id=r, tokens=toks, max_new_tokens=g)
                         for r, (toks, g) in zip(self.rids, backlog)]
        self.prompts = {r.request_id: r.tokens for r in self.requests}
        self.full = self.followed(backlog)

    def followed(self, backlog) -> List[str]:
        """The requests whose every stage the check follows, chosen before
        the window among those sent early in it: the one with the most
        rows, and others drawn from the seed."""
        t = self.traffic
        first = t["clients"] + t["warm_completions"]
        pool = list(range(first, min(first + t["check_among"],
                                     len(backlog))))
        rows = lambda k: len(backlog[k][0]) + backlog[k][1]
        longest = max(pool, key=rows)
        rest = [k for k in pool if k != longest]
        rng = np.random.default_rng(self.seed)
        pick = rng.choice(rest, size=min(t["check_requests"] - 1, len(rest)),
                          replace=False)
        return [self.rids[k] for k in sorted([longest] + list(pick))]

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float, tracer) -> Dict[str, Any]:
        t = self.traffic
        loop = _Loop(t["clients"], t["warm_completions"], seconds, tracer,
                     t["trace_requests"], self.rids, self.full)
        self.capture = Capture(self.sched.engine, self.cfg.num_layers,
                               {id(r.tokens): r.request_id
                                for r in self.requests},
                               self.full, loop.slots)
        self.capture.install()
        try:
            self.sched.run(self.requests, callbacks=loop)
            raise RuntimeError("the backlog ran out before the window "
                               "closed; the traffic needs a longer one")
        except WindowClosed:
            pass
        finally:
            self.capture.remove()
            tracer.stop()
        self.loop = loop
        w0, w1 = loop.open, loop.close
        self.setup_s = w0 - self.t0
        inside = lambda x: w0 <= x <= w1
        plen = {r: len(p) for r, p in self.prompts.items()}
        admitted = [r for r, x in loop.first.items() if inside(x)]
        prompt_tokens = sum(plen[r] for r in admitted)
        generated = [(x, r, i) for x, r, i in loop.tokens if inside(x)]
        ttft = [(loop.first[r] - loop.send_time(loop.index[r])) * 1e3
                for r in admitted]
        e2e = {"setup_s": self.setup_s,
               "tokens_per_s": (prompt_tokens + len(generated)) / seconds}
        if ttft:
            e2e["ttft_ms_p90"] = yardstick.percentile(ttft, 90)
        # the per-layer host readings leave the profiled stretch out
        span = yardstick.HostWindow(w0, w1, loop.stretch)
        host = [(x, r, i) for x, r, i in loop.tokens if span.holds(x)]
        ops = sum(yardstick.lm_prefill_ops(self.model, plen[r]) if i == 0
                  else yardstick.lm_decode_ops(self.model, plen[r] + i - 1)
                  for _, r, i in host)
        host_prefills = [r for _, r, i in host if i == 0]
        sent = min(len(self.rids), t["clients"] + len(loop.finished))
        sends = [loop.send_time(k) for k in range(sent)]
        self.log(f"window: {len(admitted)} prefills ({prompt_tokens} prompt "
                 f"tokens), {len(generated)} tokens generated in {seconds} "
                 f"s; set-up {self.setup_s:.3f} s; "
                 f"{len(loop.finished)} requests finished in all, the last "
                 f"{loop.finished[-1][0] - w1:.3f} s after the close")
        return {"end_to_end": e2e, "seconds": seconds,
                "attempted": sum(1 for s in sends if inside(s)),
                "failed": 0, "host": span, "ops": ops,
                "prefills": len(host_prefills),
                "prompt_tokens": sum(plen[r] for r in host_prefills),
                "decoded": len(host) - len(host_prefills),
                "prompt_pad": t["prompt_pad"], "slots": t["clients"],
                "sends": sends}

    def release(self) -> None:
        """Free the program's state before the reference runs (what the
        capture holds of its outputs stays)."""
        self.sched = self.params = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------
    def _sequences(self):
        """Per followed request: (prompt length, token ids fed, stream
        getter, request); the getter gives stream j's rows in position
        order."""
        cap = self.capture
        served = {r: toks for _, r, toks in self.loop.finished}
        rows = cap.decode_rows()
        out = []
        for rid in self.full:
            prompt = self.prompts[rid]
            if rid not in served or rid not in cap.prefills:
                cap.faults.append(f"request {rid} was not served whole")
                continue
            toks = served[rid]
            p, t = len(prompt), len(prompt) + len(toks) - 1
            at = [rows.get((rid, q)) for q in range(p, t)]
            if any(a is None for a in at):
                cap.faults.append(f"request {rid}: decode rows missing")
                continue
            fed = np.concatenate([prompt, toks[:-1]]).astype(np.int64)

            def stream(j, rid=rid, at=at):
                pre = cap.prefills[rid][j]
                if not at:
                    return pre
                dec = torch.stack([cap.decodes[i][3][j][s, 0]
                                   for i, s in at])
                return torch.cat([pre, dec])
            out.append((p, torch.from_numpy(fed).to(self.device), stream,
                        rid))
        return out

    def _served_rows(self):
        """(last-stream rows, token ids) of every served token whose rows
        the capture holds, and (embedding-stream rows, token ids fed) of
        every decode row of the finished requests."""
        cap = self.capture
        rows = cap.decode_rows()
        last, chosen, first, fed = [], [], [], []
        for _, rid, toks in self.loop.finished:
            p = len(self.prompts[rid])
            if rid in cap.prefills:
                last.append(cap.prefills[rid][-1][p - 1])
            elif rid in cap.finals:
                last.append(cap.finals[rid])
            else:
                continue
            chosen.append(int(toks[0]))
            for i in range(1, len(toks)):
                at = rows.get((rid, p + i - 1))
                if at is None:
                    cap.faults.append(f"request {rid}: decode row {i} "
                                      f"missing")
                    break
                xs = cap.decodes[at[0]][3]
                last.append(xs[-1][at[1], 0])
                chosen.append(int(toks[i]))
                first.append(xs[0][at[1], 0])
                fed.append(int(toks[i - 1]))
        dev = self.device
        ids = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
        stack = lambda v: torch.stack(v) if v else None
        return (stack(last), ids(chosen)), (stack(first), ids(fed))

    def _decode_mlp_rows(self, j: int):
        """Stream j of every occupied row of every decode step."""
        rows = [xs[j][s, 0] for slots, _, _, xs in self.capture.decodes
                for s in slots]
        return torch.stack(rows) if rows else None

    def readings(self, control: bool = False,
                 **variant) -> Dict[str, float]:
        """The compared numbers, each the widest over what it covers:
        ``stage_err``, every stage given the program's input rows
        (:func:`ref.stage_error`): the embedding of the tokens fed (from
        nothing), each layer's attention and MLP block over the followed
        requests' rows, and each layer's MLP block over every decode row;
        ``head_gap``, each served token's logit below the best of the
        reference's logits of the program's last rows. With ``control``,
        the same two as ``control_*`` for the reference computed in
        bfloat16 in the program's place; ``variant`` passes a sound
        variant to the reference (:class:`ref.Reference`)."""
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        dev = self.device
        want = ref.Reference(self.model, self.bits, self.seed, dev,
                             **variant)
        low = ref.Reference(self.model, self.bits, self.seed, dev,
                            dtype=torch.bfloat16) if control else None
        seqs = self._sequences()
        (last, chosen), (first, fed) = self._served_rows()
        out = {"stage_err": 0.0, "head_gap": 0.0}
        if control:
            out.update(control_stage_err=0.0, control_head_gap=0.0)

        def widest(key, value):
            # a NaN reads as the widest of all
            out[key] = max(out[key], value if value == value else math.inf)

        places = []

        def stage(place, fn, lfn, before, got, prompt=None):
            w = fn(before)
            err = ref.stage_error(got, w, before)
            widest("stage_err", err)
            if prompt is not None and prompt < before.shape[0]:
                # where a followed request's error lies: prompt or decode
                place += " (prompt rows %.3g, decode rows %.3g)" % (
                    ref.stage_error(got[:prompt], w[:prompt],
                                    before[:prompt]),
                    ref.stage_error(got[prompt:], w[prompt:],
                                    before[prompt:]))
            places.append((err, place))
            if lfn is not None:
                widest("control_stage_err",
                       ref.stage_error(lfn(before).float(), w, before))

        # the embedding is the stage before the first layer, from nothing
        for p, ids, stream, rid in seqs:
            stage(f"request {rid} embedding", lambda i: want.embed(ids),
                  low and (lambda i: low.embed(ids)),
                  torch.zeros_like(stream(0)), stream(0))
        if first is not None:
            stage("decode rows embedding", lambda i: want.embed(fed),
                  low and (lambda i: low.embed(fed)),
                  torch.zeros_like(first), first)
        lows = low.layers() if low is not None else None
        for l, w in enumerate(want.layers()):
            lw = next(lows) if lows is not None else None
            for p, ids, stream, rid in seqs:
                x_in, x_mid = stream(2 * l), stream(2 * l + 1)
                stage(f"request {rid} layer {l} attention",
                      lambda x: want.attention(x, w, p),
                      lw and (lambda x: low.attention(x, lw, p)),
                      x_in, x_mid, p)
                stage(f"request {rid} layer {l} MLP",
                      lambda x: want.mlp(x, w),
                      lw and (lambda x: low.mlp(x, lw)),
                      x_mid, stream(2 * l + 2), p)
            x_mid = self._decode_mlp_rows(2 * l + 1)
            if x_mid is not None:
                stage(f"decode rows layer {l} MLP",
                      lambda x: want.mlp(x, w),
                      lw and (lambda x: low.mlp(x, lw)),
                      x_mid, self._decode_mlp_rows(2 * l + 2))
        places.sort(key=lambda e: -e[0])
        self.log("check: widest stages " + "; ".join(
            f"{place} {err:.3g}" for err, place in places[:4]))
        if last is not None:
            for a in range(0, last.shape[0], LOGIT_ROWS):
                rows, toks = last[a:a + LOGIT_ROWS], chosen[a:a + LOGIT_ROWS]
                logits = want.logits(rows)
                widest("head_gap", float(ref.served_gaps(logits, toks).max()))
                if low is not None:
                    mine = low.logits(rows).argmax(dim=-1)
                    widest("control_head_gap",
                           float(ref.served_gaps(logits, mine).max()))
        served = 0 if last is None else int(last.shape[0])
        self.log(f"check: {len(seqs)} requests followed whole "
                 f"({sum(s[0] for s in seqs)} prompt rows), {served} "
                 f"served tokens, "
                 f"{len(self.capture.decodes)} decode steps")
        if self.capture.faults or not seqs or not served:
            self.log("check: " + "; ".join(self.capture.faults
                                           or ["nothing to compare"]))
            out = {k: math.inf for k in out}
        return out

    def check(self) -> Tuple[Dict, bool]:
        limits = self.cell.config["correct"]
        got = self.readings()
        checks = {k: {"value": got[k], "limit": limits[k]} for k in limits}
        return checks, all(c["value"] <= c["limit"] for c in checks.values())
