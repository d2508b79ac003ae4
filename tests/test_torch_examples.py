"""The port's examples (``examples/torch/*.py``) on the CPU, in-process,
at their smallest arguments (the CNN example, which has none, on 8 of its
128 evaluation images: :func:`_fewer_test_images`): each runs to its end
and prints the lines its JAX counterpart prints, and every analytical
line (the cell, the grouping, the power, ``network_perf``, the
comparison platforms, PhPIM, the OPIMA estimates) equals the line the
JAX package's functions give, character for character. Measured lines (accuracies, wall-clock times,
tokens) are checked for their form and sense only.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.baselines import ALL_PLATFORMS as J_PLATFORMS
from repro.core.baselines import PHPIM_MODEL as J_PHPIM
from repro.core.cell import CellDesign as JCell
from repro.core.cell import best_design as j_best_design
from repro.core.perfmodel import best_grouping as j_best_grouping
from repro.core.perfmodel import network_perf as j_network_perf
from repro.core.perfmodel import total_power_w as j_power
from repro.core.pim import PimConfig as JPimConfig
from repro.core.workloads import resnet18 as j_resnet18
from repro.launch.serve import opima_lm_estimate as j_estimate
from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.data.pipeline import DataConfig, LMDataIterator
from repro_torch.launch import train as t_train

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"
NAMES = ("quickstart", "cnn_pim_inference", "serve_pim_lm",
         "continuous_serving", "train_lm")


@pytest.fixture(autouse=True)
def _one_thread():
    """Each example on one intra-op thread: the test workers share the
    machine's cores, and the examples' many small CPU ops slow down many
    times over when every worker runs all of its threads at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, capsys, *argv, patch=None):
    mod = _example(name)
    if patch:
        patch(mod)
    res = mod.main(["--device", "cpu", *argv])
    return res, capsys.readouterr().out.splitlines()


def _has(lines, *want):
    missing = [w for w in want if w not in lines]
    assert not missing, (missing, lines)


def _perf_lines():
    perf = j_network_perf("resnet18", j_resnet18(), weight_bits=4,
                          act_bits=4)
    return perf, (f"   ResNet18 int4: processing {perf.processing_s*1e6:.1f}"
                  f" us + writeback {perf.writeback_s*1e6:.1f} us "
                  f"= {perf.fps:.0f} FPS, {perf.fps/j_power():.0f} FPS/W")


def test_quickstart(capsys):
    res, lines = _run("quickstart", capsys)
    w = jnp.arange(0.30, 0.71, 0.02)
    t = jnp.arange(10.0, 40.1, 2.5)
    _, perf_line = _perf_lines()
    _has(lines,
         f"   transmission contrast dT = {float(JCell().contrast()):.3f} "
         "(paper ~0.96) -> 16 levels -> 4 bits/cell",
         f"   swept optimum: {j_best_design(w, t)}",
         f"   optimal subarray grouping: {j_best_grouping()} (paper: 16)",
         f"   operating power: {j_power():.1f} W (paper: 55.9 W)",
         perf_line,
         "   bit-exact vs int oracle: True",
         "   exact-torch twin bit-identical: True")
    assert res["exact"] and res["twin"]
    assert 0.0 < res["analog_rel_err"] < 0.5
    assert any(l.startswith("   substrates: ") and "exact-cuda" in l
               for l in lines)


CNN_TEST_IMAGES = 8


def _fewer_test_images(mod):
    """The CNN example's evaluation set cut from 128 images to
    ``CNN_TEST_IMAGES`` (its training set and model stay as they are): on
    CPU tensors the noisy analog readout's plain version hashes a counter
    per chunk, row and column, about 150 core-seconds for the 128 images,
    which is for the card (``chip_smoke.py`` runs the example whole)."""
    draw = mod.synthetic_images

    def images(seed, n, *args, **kwargs):
        return draw(seed, CNN_TEST_IMAGES if seed == 1 else n, *args,
                    **kwargs)
    mod.synthetic_images = images


def test_cnn_pim_inference(capsys):
    res, lines = _run("cnn_pim_inference", capsys,
                      patch=_fewer_test_images)
    full = j_resnet18()
    perf = j_network_perf("resnet18", full, weight_bits=4, act_bits=4)
    want = [f"OPIMA @ {j_power():.1f} W:",
            f"  latency {perf.latency_s*1e3:.3f} ms "
            f"(processing {perf.processing_s*1e3:.3f} + "
            f"writeback {perf.writeback_s*1e3:.3f})",
            f"  {perf.fps:.0f} FPS | {perf.fps/j_power():.0f} FPS/W | "
            f"EPB {perf.epb()*1e12:.0f} pJ/bit"]
    want += [f"  {p.name:11s} {p.latency_s(full, 4)*1e3:8.3f} ms | "
             f"{p.fps_per_watt(full, 4):8.1f} FPS/W | "
             f"EPB {p.epb_j_per_bit()*1e12:7.0f} pJ/bit"
             for p in J_PLATFORMS]
    want.append(f"  {'PhPIM':11s} "
                f"{J_PHPIM.latency_s('resnet18', full)*1e3:8.3f} ms"
                f" | {J_PHPIM.fps_per_watt('resnet18', full):8.1f} FPS/W")
    _has(lines, *want)
    assert lines[0].startswith("model: reduced ResNet18, ")
    assert re.fullmatch(r"accuracy: fp32 [01]\.\d{3} \| PIM int4 \(exact\) "
                        r"[01]\.\d{3} \| PIM analog 5b-ADC [01]\.\d{3}",
                        lines[1])
    assert all(0.0 <= res[k] <= 1.0 for k in ("acc_fp", "acc_pim",
                                              "acc_analog"))


def _estimate_lines(keys, est):
    return [f"  {k} = {est[k]:.4g}" for k in keys]


def test_serve_pim_lm(capsys):
    res, lines = _run("serve_pim_lm", capsys, "--batch", "1")
    cfg = j_get_config("qwen2.5-3b")
    cfg = cfg.reduced(num_layers=4, d_model=128,
                      vocab=min(cfg.vocab_size, 512))
    est = j_estimate(cfg, 1, 32, 16, JPimConfig(weight_bits=4, act_bits=4))
    _has(lines, "arch=qwen2.5-3b (reduced 4L/128d), batch=1, "
         "substrate=exact-cuda",
         *_estimate_lines(("opima_latency_ms_per_token_batch",
                           "opima_energy_mj_per_token_batch",
                           "opima_power_w"), est))
    assert np.asarray(res["generated"]).shape == (1, 16)
    assert any(l.startswith("wall-clock: prefill ") and
               l.endswith(" ms/token (cpu)") for l in lines)


def test_continuous_serving(capsys):
    res, lines = _run("continuous_serving", capsys, "--requests", "1",
                      "--slots", "1")
    cfg = j_get_config("qwen2.5-3b")
    cfg = cfg.reduced(num_layers=2, d_model=64,
                      vocab=min(cfg.vocab_size, 512))
    est = j_estimate(cfg, 1, 0, 1, JPimConfig())
    pass_s = est["opima_latency_ms_per_token_batch"] / 1e3
    passes = res["decode_steps"] + sum(r["prompt_len"]
                                       for r in res["requests"])
    _has(lines, "arch=qwen2.5-3b (reduced 2L/64d), substrate=exact-cuda: "
         "1 requests through 1 slots",
         f"  opima_latency_ms_per_token_batch = {pass_s * 1e3:.4g}",
         f"  opima_tokens_per_s = "
         f"{res['generated_tokens'] / (pass_s * passes):.4g}",
         f"  opima_power_w = {est['opima_power_w']:.4g}")
    assert res["prefill_traces"] == 1 and res["decode_traces"] == 1
    assert any(l.startswith("  req 0: arrival ") for l in lines)


def test_continuous_serving_sanitize_names_its_item(capsys):
    """A13 is ported: ``--sanitize`` arms the guard and the compile
    counter, and the example prints what it counted, as JAX's does."""
    res = _example("continuous_serving").main(["--device", "cpu",
                                                "--requests", "1",
                                                "--sanitize"])
    assert res["sanitize"]["compiles"] == {"prefill": 1, "insert": 1,
                                           "decode": 1}
    assert "  sanitize: decode host-read guard armed, compiles {'prefill': " \
           "1, 'insert': 1, 'decode': 1}" in capsys.readouterr().out


def test_train_lm_resumes(tmp_path, capsys):
    """50 steps write the step-50 checkpoint; 60 steps from the same
    directory resume from it and go on from its loss."""
    args = ["--layers", "1", "--d-model", "32", "--batch", "1", "--seq",
            "8", "--ckpt-dir", str(tmp_path)]
    first, lines = _run("train_lm", capsys, "--steps", "50", *args)
    assert lines[-1] == (f"loss: {first['first_loss']:.4f} -> "
                         f"{first['last_loss']:.4f} (re-run the same command "
                         "to exercise checkpoint resume)")
    second, lines = _run("train_lm", capsys, "--steps", "60", *args)
    assert "[train] resumed from step 50" in lines
    assert lines[1].startswith("[train] step    50 loss ")
    # the resumed run's first loss is the step-50 checkpoint's on the
    # data iterator's step-50 batch, bit for bit, not a fresh model's
    cfg = t_get_config("gemma3-1b").reduced(num_layers=1, d_model=32,
                                            vocab=512)
    blank = t_train.init_state(cfg, 0, device="cpu")
    state, step, extras = restore_checkpoint(str(tmp_path), blank)
    it = LMDataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                   global_batch=1), cfg)
    it.restore(extras["data_step"])
    batch = t_train.batch_to_device(next(it), "cpu")
    _, resumed = t_train.lm_loss(state["params"], cfg, batch)
    _, fresh = t_train.lm_loss(blank["params"], cfg, batch)
    assert step == 50 and float(resumed["loss"]) == second["first_loss"]
    assert float(fresh["loss"]) != second["first_loss"]


def test_examples_keep_the_reference_arguments():
    """Each example takes its JAX counterpart's arguments and defaults,
    plus ``--device`` (default ``cuda``); ``train_lm`` adds
    ``--attn-backend`` and keeps its checkpoints under
    ``/tmp/repro_torch_ckpt``."""
    ref = Path(__file__).resolve().parents[1] / "examples"
    for name in NAMES:
        want = set(re.findall(r'add_argument\("(--[a-z-]+)"',
                              (ref / f"{name}.py").read_text()))
        got = set(re.findall(r'add_argument\("(--[a-z-]+)"',
                             (EXAMPLES / f"{name}.py").read_text()))
        extra = {"--device"} | ({"--attn-backend"} if name == "train_lm"
                                else set())
        assert got == want | extra, name
    src = (EXAMPLES / "train_lm.py").read_text()
    assert 'default="/tmp/repro_torch_ckpt"' in src
