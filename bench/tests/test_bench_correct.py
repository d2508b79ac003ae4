"""The comparison that decides ``correct``, on the CPU at sizes a test run
holds: the plain references agree with the program through its plain
substrates, the control (the reference one precision lower in the
program's place) is judged not correct, and so is a run whose timed path
is broken underneath."""
import time

import pytest
import torch

from conftest import tiny

from bench import harness
from bench.harness import Spans, Tracer

SEED = 2 ** 31 + 12345


def quiet(*args):
    pass


def fails(cell, readings):
    """Whether the control's readings fail one of the cell's limits while
    the program's pass them all."""
    limits = cell.config["correct"]
    assert all(readings[k] <= v for k, v in limits.items()), readings
    return any(readings["control_" + k] > v for k, v in limits.items())


def served(cell, seconds=1.0):
    """Set up, serve and release one tiny run; returns the system."""
    s = cell.driver().System(cell, SEED, "cpu", quiet, time.perf_counter())
    s.setup()
    s.window(seconds, Tracer(False, Spans([])))
    s.release()
    return s


@pytest.mark.parametrize("workload", ["resnet18.b128", "qwen3-4b.doc4k"])
def test_reference_agrees_with_the_program(workload):
    res = harness.run(tiny(workload), SEED, 1.0, False, device="cpu",
                      log=quiet)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    for check in res["checks"].values():
        assert check["value"] <= 0.01 * check["limit"]


def test_cnn_control_is_not_correct():
    cell = tiny("resnet18.b128")
    r = served(cell).readings(control=True)
    assert r["logit_gap"] <= cell.config["correct"]["logit_gap"] \
        < r["control_gap"]


def test_lm_control_is_not_correct():
    cell = tiny("qwen3-4b.doc4k")
    assert fails(cell, served(cell, 2.0).readings(control=True))


def test_lm_stages_chain_to_the_whole_model():
    """The reference's stages, chained from the embedding, give the
    program's logits of a prompt (one request through the program's
    plain prefill)."""
    from bench.reference import lm as ref
    cell = tiny("qwen3-4b.doc4k")
    s = served(cell, 1.0)
    rid = s.full[0]
    prompt = torch.as_tensor(s.prompts[rid], dtype=torch.int64)
    want = ref.Reference(s.model, s.bits, SEED, "cpu").forward(
        prompt, len(prompt))[-1]
    got = s.capture.prefills[rid][-1][-1]
    logits = ref.Reference(s.model, s.bits, SEED, "cpu").logits(got[None])
    assert torch.allclose(logits[0], want, atol=1e-4)


def _half_batch_cnn(monkeypatch):
    from repro_torch.models import cnn
    forward = cnn.cnn_forward

    def half(params, layers, x, **kw):
        keep = x.shape[0] // 2
        out = forward(params, layers, x[:keep], **kw)
        return torch.cat([out, out.mean(0, keepdim=True).expand(
            x.shape[0] - keep, -1)])
    monkeypatch.setattr(cnn, "cnn_forward", half)


def _altered_cnn(monkeypatch):
    from repro_torch.models import cnn
    forward = cnn.cnn_forward

    def altered(*args, **kw):
        out = forward(*args, **kw).clone()
        out[0] = out[0].flip(0)           # one image's answer altered
        return out
    monkeypatch.setattr(cnn, "cnn_forward", altered)


def _half_batch_lm(monkeypatch):
    from repro_torch.serving.engine import ServingEngine
    decode = ServingEngine._decode_fn

    def half(self, params, cache, toks, pos, fallback=False):
        nxt, stop, cache = decode(self, params, cache, toks, pos, fallback)
        keep = nxt.shape[0] // 2
        return torch.cat([nxt[:keep], torch.zeros_like(nxt[keep:])]), \
            stop, cache
    monkeypatch.setattr(ServingEngine, "_decode_fn", half)


def _altered_lm(monkeypatch):
    from repro_torch.serving.engine import ServingEngine
    decode = ServingEngine._decode_fn

    def altered(self, params, cache, toks, pos, fallback=False):
        nxt, stop, cache = decode(self, params, cache, toks, pos, fallback)
        return (nxt + 1) % self.cfg.vocab_size, stop, cache
    monkeypatch.setattr(ServingEngine, "_decode_fn", altered)


def _nan_cnn(monkeypatch):
    from repro_torch.models import cnn
    forward = cnn.cnn_forward

    def nan(*args, **kw):
        out = forward(*args, **kw).clone()
        out[:, 0] = float("nan")          # a NaN in every answer
        return out
    monkeypatch.setattr(cnn, "cnn_forward", nan)


def _nan_lm(monkeypatch):
    from repro_torch.models import lm
    mlp = lm.mlp_apply

    def nan(p, x, activation):
        return mlp(p, x, activation) * float("nan")
    monkeypatch.setattr(lm, "mlp_apply", nan)


def _unchanged_lm(monkeypatch):
    from repro_torch.models import lm

    def unchanged(p, x, activation):
        return torch.zeros_like(x)        # the layer's MLP leaves its state
    monkeypatch.setattr(lm, "mlp_apply", unchanged)


def _half_rows_lm(monkeypatch):
    from repro_torch.models import attention
    block = attention.attention_block

    def half(*args, **kw):
        out = block(*args, **kw)
        o = out[0] if isinstance(out, tuple) else out
        keep = o.shape[1] // 2
        o = torch.cat([o[:, :keep], o[:, :keep].mean(1, keepdim=True)
                       .expand(-1, o.shape[1] - keep, -1)], 1)
        return (o,) + tuple(out[1:]) if isinstance(out, tuple) else o
    monkeypatch.setattr(attention, "attention_block", half)


@pytest.mark.parametrize("workload, fault", [
    ("resnet18.b128", _half_batch_cnn), ("resnet18.b128", _altered_cnn),
    ("qwen3-4b.doc4k", _half_batch_lm), ("qwen3-4b.doc4k", _altered_lm),
    ("qwen3-4b.doc4k", _unchanged_lm), ("qwen3-4b.doc4k", _half_rows_lm),
    ("resnet18.b128", _nan_cnn), ("qwen3-4b.doc4k", _nan_lm)],
    ids=["cnn-half-batch", "cnn-answer-altered", "lm-half-batch",
         "lm-token-altered", "lm-state-unchanged", "lm-half-rows",
         "cnn-nan-answer", "lm-nan-state"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    res = harness.run(tiny(workload), SEED, 1.0, False, device="cpu",
                      log=quiet)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_a_cell_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    harness.use_cache_dirs()
    res = harness.run(harness.Cell("resnet18.b128"), SEED, 2.0, False,
                      log=quiet)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
