"""The port's static analysis and runtime sanitizers
(``repro_torch.analysis``): a fixture per rule with exact rule id and
line, suppressions, the registry, the hot set over ``src/repro_torch``,
the self-run at zero findings, parity with the JAX package's lint where a
rule's meaning carries over, the import rule, and the sanitizers on the
CPU: the host-read guard tripping inside the window and not outside it,
the real scheduler armed on a reduced qwen3, the compile counter, serve's
``--sanitize`` result and the compile cache's directory."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import lint as jax_lint
from repro.analysis.sanitize import Sanitizer as JaxSanitizer
from repro_torch.analysis import (available_checkers, get_checker,
                                  lint_paths, lint_source)
from repro_torch.analysis import lint as port_lint
from repro_torch.analysis.lint import build_project
from repro_torch.analysis.sanitize import (CompileCountError,
                                           CompileCounter, HostSyncError,
                                           Sanitizer, record_compile)
from repro_torch.configs.base import get_config
from repro_torch.kernels import runtime
from repro_torch.launch import serve
from repro_torch.models import attention, lm
from repro_torch.serving import (ContinuousScheduler, ServingEngine,
                                 poisson_trace)

REPO = Path(__file__).resolve().parents[1]
PORT_PATHS = [str(REPO / "src" / "repro_torch"),
              str(REPO / "examples" / "torch")]


def _lint(src, **kw):
    return lint_source(textwrap.dedent(src), **kw)


def _hits(findings):
    return [(f.rule, f.line) for f in findings]


# ---------------------------------------------------------------------------
# per-rule fixtures: exact rule id and line number
# ---------------------------------------------------------------------------
def test_rpr101_reads_from_the_device():
    f = _lint("""\
    import numpy as np
    import torch

    def hot(x):
        y = torch.sum(x)
        a = y.item()
        b = (y + 1).tolist()
        c = y.cpu()
        d = y.numpy()
        e = y.to("cpu")
        g = float(y)
        h = np.asarray(y)
        k = torch.equal(y, y)
        return a, b, c, d, e, g, h, k
    """)
    assert _hits(f) == [("RPR101", n) for n in range(6, 14)]


def test_rpr101_copies_to_the_device():
    f = _lint("""\
    import torch

    NEG_INF = -1e30

    def hot(x, stops):
        a = torch.tensor(NEG_INF, device=x.device)
        b = torch.as_tensor(stops, dtype=torch.int32, device=x.device)
        c = torch.where(x > 0, x, NEG_INF)
        d = torch.tensor([1, 2])
        return a, b, c, d
    """)
    assert _hits(f) == [("RPR101", 6), ("RPR101", 7)]


def test_rpr101_taint_through_methods_and_static_metadata():
    f = _lint("""\
    import torch
    import torch.nn.functional as F

    def hot(x):
        tok = F.softmax(x, -1).argmax(-1).to(torch.int32)
        if tok.shape[0] > 4 and tok.dtype == torch.int32:
            return int(tok.numel()) + x.size(0)
        return int(tok)
    """)
    assert _hits(f) == [("RPR101", 8)]


def test_rpr101_host_returning_helper_is_clean():
    f = _lint("""\
    from typing import List
    import torch

    def counts(ids) -> List[int]:
        return [0, 1]

    def hot(x):
        rows = sum(counts(torch.argsort(x)))
        if rows:
            return rows
        return 0
    """)
    assert _hits(f) == []


def test_rpr102_truthiness_of_a_tensor():
    f = _lint("""\
    import torch

    def hot(x):
        y = torch.max(x)
        if y > 0:
            return 1
        assert (y >= 0).all()
        while y:
            y = y - 1
        return 0
    """)
    assert _hits(f) == [("RPR102", 5), ("RPR102", 7), ("RPR102", 8)]


def test_rpr201_fresh_compile_per_call():
    f = _lint("""\
    import torch

    def step(f, x):
        return torch.compile(f)(x)
    """, assume_hot=False)
    assert _hits(f) == [("RPR201", 4)]


def test_rpr202_branch_inside_a_compile_target():
    f = _lint("""\
    import torch

    @torch.compile
    def step(x):
        y = torch.sum(x)
        if y > 0:
            return y
        return -y

    def plain(x):
        y = torch.sum(x)
        if y > 0:
            return y
        return -y

    class Engine:
        def __init__(self):
            self._fn = torch.compile(self_step)

    def self_step(x):
        if torch.any(x):
            return x
        return -x
    """, assume_hot=False)
    assert _hits(f) == [("RPR202", 6), ("RPR202", 21)]


def test_rpr203_set_iteration():
    f = _lint("""\
    def build(keys):
        s = set(keys)
        return [k for k in s]
    """, assume_hot=False)
    assert _hits(f) == [("RPR203", 3)]


def test_rpr301_tensor_dataclass_the_walkers_miss():
    f = _lint("""\
    import dataclasses
    from typing import Optional
    import torch
    from repro_torch.core.pim import Plan

    @dataclasses.dataclass
    class State:
        x: torch.Tensor
        step: int

    @dataclasses.dataclass
    class MyPlan(Plan):
        values: torch.Tensor

    @dataclasses.dataclass
    class Meta:
        y: Optional[torch.Tensor] = None
    """, assume_hot=False)
    assert _hits(f) == [("RPR301", 7), ("RPR301", 16)]


def test_rpr401_unchecked_pointer_to_a_kernel():
    src = """\
    import torch

    def _check_planes(a):
        return a

    def launch(lib, a, b, s):
        _check_planes(a)
        out = torch.empty((4,), device=a.device)
        c = b.contiguous()
        return lib.kernel(a.data_ptr(), c.data_ptr(), out.data_ptr(),
                          s.data_ptr(), None if s is None else s.data_ptr())
    """
    f = _lint(src, module="repro_torch.kernels.fixture", assume_hot=False)
    assert _hits(f) == [("RPR401", 11), ("RPR401", 11)]
    # outside repro_torch.kernels the rule does not apply
    assert _hits(_lint(src, assume_hot=False)) == []


def test_rpr402_fallbacks_to_the_plain_version():
    f = _lint("""\
    import torch

    def init(n, device="cpu"):
        return torch.zeros(n, device=device)

    def make(n, *, device=torch.device("cpu")):
        return torch.zeros(n, device=device)

    def matmul(x, w):
        try:
            return pim_matmul_cuda(x, w)
        except RuntimeError:
            return pim_matmul_ref(x, w)

    def strict(x, w):
        try:
            return pim_matmul_cuda(x, w)
        except RuntimeError as e:
            raise ValueError("no kernel") from e
    """, assume_hot=False)
    assert _hits(f) == [("RPR402", 3), ("RPR402", 6), ("RPR402", 12)]


def test_rpr501_jax_substrate_aliases():
    f = _lint("""\
    def configure(cfg):
        a = PimConfig(substrate="exact-pallas")
        b = "analog-pallas"
        c = "exact-cuda"
        return a, b, c
    """, assume_hot=False)
    assert _hits(f) == [("RPR501", 2), ("RPR501", 3)]
    assert _lint('X = "exact-pallas"\n', module="repro_torch.core.pim",
                 assume_hot=False) == []


# ---------------------------------------------------------------------------
# suppression + registry + hot set
# ---------------------------------------------------------------------------
def test_inline_suppression_same_and_previous_line():
    f = _lint("""\
    import torch

    def hot(x):
        y = torch.sum(x)
        a = float(y)  # repro-lint: disable=RPR101 (reason)
        # repro-lint: disable=all (reason)
        b = float(y)
        c = float(y)
        return a, b, c
    """)
    assert _hits(f) == [("RPR101", 8)]


def test_select_and_ignore():
    src = """\
    import torch

    def hot(x, device="cpu"):
        return float(torch.sum(x))
    """
    assert {r for r, _ in _hits(_lint(src))} == {"RPR101", "RPR402"}
    assert _hits(_lint(src, select=["RPR402"])) == [("RPR402", 3)]
    assert _hits(_lint(src, ignore=["RPR402"])) == [("RPR101", 4)]


def test_checker_registry():
    assert set(available_checkers()) == {
        "host-sync", "recompile", "tree", "kernel-boundary",
        "substrate-alias"}
    assert get_checker("host-sync").rules == ("RPR101", "RPR102")
    rules = {r for n in available_checkers() for r in get_checker(n).rules}
    assert rules == set(port_lint.RULES) == set(jax_lint.RULES)
    with pytest.raises(ValueError, match="unknown checker"):
        get_checker("nope")


def test_hot_set_covers_the_serving_path():
    project = build_project(PORT_PATHS, root=str(REPO))
    for q in ("repro_torch.models.lm.decode_step",
              "repro_torch.serving.scheduler.ContinuousScheduler.run",
              "repro_torch.engine.api.matmul",
              # through generate's lambda into _decode_fn
              "repro_torch.serving.engine.ServingEngine._decode_fn",
              "repro_torch.models.attention._sdpa"):
        assert q in project.hot, q
    # the training loop is on no serving root's path
    assert not project.is_hot("repro_torch.launch.train.main")


def test_self_run_is_clean():
    """The gate: the port's lint over the port reports nothing."""
    findings = lint_paths(PORT_PATHS, root=str(REPO))
    assert findings == [], "\n".join(x.render() for x in findings)


def test_cli_exit_codes(capsys, tmp_path):
    from repro_torch.analysis import cli
    own = str(REPO / "src" / "repro_torch" / "analysis")
    assert cli.main(["--no-ruff", "--root", str(REPO), own]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    bad = tmp_path / "bad.py"
    bad.write_text('SUBSTRATE = "exact-pallas"\n')
    assert cli.main(["--no-ruff", "--root", str(tmp_path), str(bad)]) == 1
    assert "RPR501" in capsys.readouterr().out
    assert cli.main(["--list-rules"]) == 0
    assert "RPR401" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        cli.main(["--bogus-flag"])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# parity with the JAX package's lint where the meaning carries over
# ---------------------------------------------------------------------------
_SHARED_FIXTURES = {
    # jnp.max taints for JAX, torch.max for the port: the sum is device in
    # both, so the branch and the assert flag at the same lines
    "RPR102": """\
    import jax.numpy as jnp
    import torch

    def hot(x):
        y = jnp.max(x) + torch.max(x)
        if y > 0:
            return 1
        assert y
        if x is not None:
            return 2
        return 0
    """,
    "RPR203": """\
    def build(keys):
        s = {k for k in keys}
        out = [k for k in s]
        for k in set(keys):
            out.append(k)
        t = set(keys)
        t = sorted(t)
        return [k for k in t]
    """,
    "suppression": """\
    import jax.numpy as jnp
    import torch

    def hot(x):
        y = jnp.max(x) + torch.max(x)
        if y > 0:  # repro-lint: disable=RPR102 (reason)
            return 1
        # repro-lint: disable=RPR102,RPR101 (reason)
        if y > 1:
            return 2
        # repro-lint: disable=all
        assert y
        if y < 0:
            return 3
        return 0
    """,
}


@pytest.mark.parametrize("name", sorted(_SHARED_FIXTURES))
def test_shared_rules_match_the_jax_lint(name):
    src = textwrap.dedent(_SHARED_FIXTURES[name])
    rules = ["RPR102", "RPR203"]
    port = _hits(lint_source(src, select=rules))
    jax = _hits(jax_lint.lint_source(src, select=rules))
    assert port == jax and port


def test_module_naming_matches_the_jax_lint(tmp_path):
    for rel in ("src/repro_torch/core/pim.py", "src/repro_torch/__init__.py",
                "examples/torch/quickstart.py", "benchmarks/run.py"):
        path = tmp_path / rel
        assert port_lint._module_name(path, tmp_path) == \
            jax_lint._module_name(path, tmp_path)
    assert port_lint._module_name(tmp_path / "src/repro_torch/core/pim.py",
                                  tmp_path) == "repro_torch.core.pim"


def test_lint_modules_import_neither_torch_nor_jax():
    code = ("import sys\n"
            "import repro_torch.analysis, repro_torch.analysis.lint\n"
            "import repro_torch.analysis.callgraph\n"
            "import repro_torch.analysis.checkers\n"
            "import repro_torch.analysis.cli\n"
            "bad = [m for m in ('torch', 'jax', 'repro') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin"})


# ---------------------------------------------------------------------------
# runtime sanitizers on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("read", ["tensor", "as_tensor", "item", "bool",
                                  "tolist", "cpu"])
def test_guard_trips_on_a_host_reading_decode_loop(read):
    san = Sanitizer()
    tok = torch.zeros((4,), dtype=torch.int64)
    steps = {
        "tensor": lambda t: t + torch.tensor(1, device=t.device),
        "as_tensor": lambda t: t + torch.as_tensor([1, 1, 1, 1]),
        "item": lambda t: t + int(t.sum().item()),
        "bool": lambda t: t + 1 if (t >= 0).all() else t,
        "tolist": lambda t: t + len(t.tolist()),
        "cpu": lambda t: t.cpu() + 1,
    }
    with pytest.raises(HostSyncError, match="decode window"):
        with san.decode_guard("cpu"):
            for _ in range(3):
                tok = steps[read](tok)
    # the same reads are legal outside the window
    assert steps[read](tok).shape == (4,)


def test_guard_allows_device_side_forms():
    """The repaired forms (a Python scalar in torch.where, a tensor
    already in place) pass; placement by from_numpy stays legal."""
    san = Sanitizer()
    x = torch.randn(2, 3, generator=torch.Generator().manual_seed(0))
    with san.decode_guard("cpu"):
        y = torch.where(x > 0, x, attention.NEG_INF)
        stop = lm.token_stop_mask(torch.ones((2,), dtype=torch.int64),
                                  torch.zeros((0,), dtype=torch.int32))
        z = torch.from_numpy(np.ones(3, np.float32)).to(x.device)
    assert y.min() == torch.tensor(attention.NEG_INF) and not stop.any()
    assert z.sum().item() == 3.0


def test_repaired_masks_keep_the_bits():
    """``_sdpa``'s and ``_vocab_mask``'s scalar forms equal the tensor
    forms they replaced, bit for bit."""
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(2, 5, 7, generator=g)
    mask = torch.rand(2, 5, 7, generator=g) > 0.4
    old = torch.where(mask, logits, torch.tensor(attention.NEG_INF,
                                                 dtype=logits.dtype))
    assert torch.equal(torch.where(mask, logits, attention.NEG_INF), old)
    cfg = get_config("qwen3-4b").reduced(num_layers=1, d_model=64, vocab=100)
    assert cfg.padded_vocab != cfg.vocab_size
    x = torch.randn(3, cfg.padded_vocab, generator=g)
    pad = torch.arange(cfg.padded_vocab) >= cfg.vocab_size
    bias = torch.where(pad, torch.tensor(-1e30), torch.tensor(0.0))
    assert torch.equal(lm._vocab_mask(cfg, x), x + bias.to(x.dtype))


def test_guard_leaves_no_mode_behind():
    """On the CPU the guard is the TorchFunctionMode and leaves the
    process's mode stack as it was, also after a trip."""
    san = Sanitizer()
    with pytest.raises(HostSyncError):
        with san.decode_guard("cpu"):
            torch.ones(2).sum().item()
    assert torch.ones(2).sum().item() == 2.0
    assert Sanitizer(transfer_guard=False).decode_guard("cpu") is not None


def _tiny():
    cfg = get_config("qwen3-4b").reduced(num_layers=2, d_model=64,
                                         vocab=128)
    return cfg, lm.init_lm(cfg, 0, device="cpu")


def _trace(cfg):
    return poisson_trace(n=4, rate=0.0, prompt_lens=[2, 5, 8],
                         gen_lens=[2, 4], vocab=cfg.vocab_size, seed=3)


@pytest.mark.parametrize("mode", [
    {"sync_every": 1},
    {"sync_every": 2},
    {"sync_every": 1, "prefill_chunk": 4},
], ids=["decode", "window", "chunked"])
def test_sanitized_scheduler_is_clean_and_keeps_the_tokens(mode):
    cfg, params = _tiny()
    reqs = _trace(cfg)
    geo = dict(num_slots=2, prompt_pad=8, max_len=16, **mode)
    plain = ContinuousScheduler(params, cfg, **geo)
    plain.warmup()
    want = plain.run(reqs).tokens_by_id()
    san = Sanitizer()
    sched = ContinuousScheduler(params, cfg, sanitizer=san, **geo)
    prefill = "prefill_chunk" if "prefill_chunk" in mode else "prefill"
    with san.compile_counter(names=(prefill, "insert", "decode",
                                    "decode_window")) as counter:
        sched.warmup()
        got = sched.run(reqs).tokens_by_id()
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    expected = {prefill: 1, "insert": 1, "decode": 1}
    if mode["sync_every"] > 1:
        expected["decode_window"] = 1
    counter.expect(**expected)


def test_guard_wraps_the_decode_step_only(monkeypatch):
    """A host read in the decode step raises through the engine; the same
    read in prefill (outside the window) does not."""
    cfg, params = _tiny()
    eng = ServingEngine(params, cfg, num_slots=2, prompt_pad=8, max_len=16,
                        sanitizer=Sanitizer())
    state = eng.init_state()
    real = lm.decode_step

    def reading_step(*args, **kw):
        logits, cache = real(*args, **kw)
        return logits + torch.tensor(0.0, device=logits.device), cache

    monkeypatch.setattr(lm, "prefill", _reading(lm.prefill))
    state, _ = eng.insert(eng.prefill(np.arange(5) % cfg.vocab_size),
                          state, max_new_tokens=4)
    eng.generate(state)
    monkeypatch.setattr(lm, "decode_step", reading_step)
    with pytest.raises(HostSyncError):
        eng.generate(state)


def _reading(fn):
    def wrapped(*args, **kw):
        logits, cache = fn(*args, **kw)
        return logits + torch.tensor(0.0), cache
    return wrapped


def test_nan_debug_raises_in_a_session_only():
    cfg, params = _tiny()
    san = Sanitizer(nan_debug=True)
    eng = ServingEngine(params, cfg, num_slots=2, prompt_pad=8, max_len=16,
                        sanitizer=san)
    state = eng.init_state()
    state, _ = eng.insert(eng.prefill(np.arange(5) % cfg.vocab_size),
                          state, max_new_tokens=4)
    # an empty slot's row, at a position its decode neither writes nor reads
    state.cache["k"][0, 1, 5] = float("nan")
    state, _ = eng.generate(state)                   # outside: unchecked
    with san.session():
        assert san.nan_armed
        with pytest.raises(FloatingPointError, match="NaN"):
            eng.generate(state)
    assert not san.nan_armed


def test_compile_counter_names_the_step_on_a_new_shape():
    cfg, params = _tiny()
    eng = ServingEngine(params, cfg, num_slots=2, prompt_pad=8, max_len=16,
                        sanitizer=Sanitizer())
    with CompileCounter(names=("prefill", "insert", "decode")) as c:
        eng.warmup()
        eng.prefill(np.arange(5) % cfg.vocab_size)     # same signature
        c.expect(prefill=1, insert=1, decode=1)
        eng._prefill_fn(eng.params, eng._tokens(np.zeros((1, 4))), 1)
    with pytest.raises(CompileCountError, match="prefill: compiled 2x"):
        c.expect(prefill=1, insert=1, decode=1)
    with CompileCounter(names=("nvcc:",)) as n:
        record_compile("nvcc:pim_matmul")
        record_compile("decode")
    assert n.counts == {"nvcc:pim_matmul": 1}


def test_serve_sanitize_result_has_the_jax_field_set(tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(runtime, "_build_dir", runtime.build_dir())
    res = serve.serve_continuous(
        "qwen3-4b", num_slots=2, num_requests=3, prompt_len=8, gen=3,
        layers=2, d_model=64, sanitize=True, seed=0, device="cpu",
        compile_cache_dir=str(tmp_path / "cache"))
    jax_fields = set(JaxSanitizer().report()) | {"compiles"}
    assert set(res["sanitize"]) == jax_fields
    assert set(res["sanitize"]["fault_log"]) == set(
        JaxSanitizer().report()["fault_log"])
    # the JAX engine compiles each step once at this geometry
    assert res["sanitize"]["compiles"] == {"prefill": 1, "insert": 1,
                                           "decode": 1}
    assert res["compile_cache"]["dir"] == str((tmp_path / "cache")
                                              .resolve())


def test_enable_compile_cache_moves_the_libraries(tmp_path, monkeypatch):
    monkeypatch.setattr(runtime, "_build_dir", runtime.build_dir())
    default = runtime.library_path("pim_matmul")
    assert default.parent == runtime.BUILD_DIR
    serve.enable_compile_cache(str(tmp_path / "kc"))
    moved = runtime.library_path("pim_matmul")
    assert moved.parent == (tmp_path / "kc").resolve()
    assert moved.name == default.name
    # nothing falls back: a directory that cannot be made raises
    (tmp_path / "file").write_text("")
    with pytest.raises(OSError):
        runtime.set_build_dir(tmp_path / "file" / "kc")
    assert runtime.build_dir() == (tmp_path / "kc").resolve()
