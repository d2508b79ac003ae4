"""Static LM serving in the port (``repro_torch.launch.serve``) against the
JAX package's: the result key set, the metrics JSON, the OPIMA hardware
estimate (pure Python on both sides, so equal exactly), what raises as
not ported, and the import rule (the port and ``chip_smoke.py`` import
neither ``jax`` nor ``repro``)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.archs import ARCH_IDS
from repro.configs.base import get_config as j_get_config
from repro.core.pim import PimConfig as JPimConfig
from repro.launch import serve as j_serve
from repro_torch.configs.base import get_config, list_archs
from repro_torch.core.pim import PimConfig
from repro_torch.launch import serve as t_serve

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(batch=2, prompt_len=8, gen=4, layers=2, d_model=64)


@pytest.mark.parametrize("arch,pim", [("mamba2-370m", True),
                                      ("qwen2.5-3b", False)])
def test_serve_returns_jax_static_keys(arch, pim):
    want = j_serve.serve(arch, pim=pim, **SMALL)
    got = t_serve.serve(arch, pim=pim, device="cpu", **SMALL)
    assert set(got) == set(want)
    assert got["mode"] == "static" and got["arch"] == want["arch"]
    assert got["generated"].shape == (2, 4)
    assert got["generated_tokens"] == 8 and got["emitted_tokens"] == 8
    if pim:
        assert got["pim_substrate"] == "exact-cuda"
        for k, v in want.items():
            if k.startswith("opima_"):
                assert got[k] == v, k


def test_serve_hymba_pim_on_cpu_and_stop_tokens():
    res = t_serve.serve("hymba-1.5b", pim=True, device="cpu",
                        pim_substrate="exact-jnp", **SMALL)
    assert res["pim_substrate"] == "exact-torch"
    first = int(res["generated"][0, 1])
    stopped = t_serve.serve("hymba-1.5b", pim=True, device="cpu",
                            pim_substrate="exact-jnp", eos_token=first,
                            **SMALL)
    np.testing.assert_array_equal(stopped["generated"], res["generated"])
    assert stopped["row_stop_reasons"][0] == "eos"
    assert stopped["emitted"][0] == res["generated"][0, :2].tolist()


def test_write_metrics_json_round_trips(tmp_path):
    res = t_serve.serve("gemma3-1b", pim=True, device="cpu", **SMALL)
    path = tmp_path / "m.json"
    t_serve.write_metrics_json(str(path), res)
    back = json.loads(path.read_text())
    assert set(back) == set(res)
    assert back["generated"] == res["generated"].tolist()
    assert back["emitted"] == res["emitted"]
    assert back["opima_power_w"] == res["opima_power_w"]
    t_serve.write_metrics_json(str(path), dict(
        res, mixed=[np.int64(3), np.float32(0.5), torch.tensor([1, 2])]))
    assert json.loads(path.read_text())["mixed"] == [3, 0.5, [1, 2]]


@pytest.mark.parametrize("bits", [4, 8])
def test_opima_lm_estimate_equals_jax(bits):
    assert sorted(list_archs()) == sorted(ARCH_IDS)
    for arch in ARCH_IDS:
        want = j_serve.opima_lm_estimate(
            j_get_config(arch), 8, 512, 16,
            JPimConfig(weight_bits=bits, act_bits=bits))
        got = t_serve.opima_lm_estimate(
            get_config(arch), 8, 512, 16,
            PimConfig(weight_bits=bits, act_bits=bits))
        assert got == want, arch


@pytest.mark.parametrize("kwargs,item", [
    ({"plan_dir": "plans"}, "A8"), ({"mesh": "1,1"}, "A11"),
    ({"compile_cache_dir": "cc"}, "A7")])
def test_unported_serve_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        t_serve.serve("qwen2.5-3b", device="cpu", **SMALL, **kwargs)


def test_substrate_resolution():
    assert t_serve._resolve_substrate(None, False) == "exact-cuda"
    assert t_serve._resolve_substrate("exact-pallas", False) == "exact-cuda"
    assert t_serve._resolve_substrate("analog-pallas", False) == \
        "analog-cuda"
    with pytest.warns(DeprecationWarning):
        assert t_serve._resolve_substrate(None, True) == "emulate"
    with pytest.raises(ValueError, match="conflicts"):
        with pytest.warns(DeprecationWarning):
            t_serve._resolve_substrate("exact-torch", True)


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_cli_static_and_continuous(tmp_path):
    out = tmp_path / "m.json"
    res = _run(["-m", "repro_torch.launch.serve", "--arch", "hymba-1.5b",
                "--layers", "2", "--d-model", "64", "--gen", "3", "--pim",
                "--device", "cpu", "--metrics-json", str(out)])
    assert res.returncode == 0, res.stderr
    assert "pim_substrate = exact-cuda" in res.stdout
    assert json.loads(out.read_text())["generated_tokens"] == 6
    res = _run(["-m", "repro_torch.launch.serve", "--arch", "qwen2.5-3b",
                "--continuous", "--device", "cpu"])
    assert res.returncode != 0 and "A7" in res.stderr


IMPORT_GUARD = r"""
import ast, importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
tree = ast.parse(open(chip_smoke.__file__).read())
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        for alias in node.names:
            importlib.import_module(alias.name)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        importlib.import_module(node.module)
        for alias in node.names:
            try:
                importlib.import_module(node.module + "." + alias.name)
            except ModuleNotFoundError:
                pass   # an attribute, not a module
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
missing = sorted(set(NEW_MODULES) - set(names))
print(len(names), "modules;", "forbidden:", bad, "missing:", missing)
sys.exit(1 if bad or missing or len(names) < 20 else 0)
"""
# modules the walk must reach (the training slice's among them)
NEW_MODULES = (
    "repro_torch.kernels.flash_attention.flash_attention",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.optim.adamw", "repro_torch.optim.compression",
    "repro_torch.checkpoint.ckpt", "repro_torch.launch.train",
    "repro_torch.data.pipeline", "repro_torch.tree")


def test_port_and_chip_smoke_import_no_jax():
    res = _run(["-c", f"NEW_MODULES = {NEW_MODULES!r}\n" + IMPORT_GUARD])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "forbidden: [] missing: []" in res.stdout
