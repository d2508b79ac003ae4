"""The hand-written flash-attention kernels (``csrc/flash_attention.cu``,
forward and backward) against their plain PyTorch version, on the card.
Every test here needs an NVIDIA GPU and nvcc and skips without them; this
file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_flash.py

Tolerances:
- forward in float32: rtol 2e-4, atol 2e-5 (the JAX kernel test's bound
  between its Pallas kernel and its reference): the kernel sums in float32
  FMAs in another order, with an online softmax;
- forward in bfloat16: rtol 3e-2, atol 3e-2 (the JAX bf16 test's bound);
- backward in float32: each of dQ, dK, dV within 1e-3 of that gradient's
  largest magnitude (float32 sums over up to S keys or S * rep queries in
  another order, through exp and the recomputed probabilities); the same
  for each backward kernel against its own plain version, and rtol 1e-6
  for delta and the head sum (a few float32 additions).
TF32 stays off for the plain version's einsums (set in the fixture).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.kernels.flash_attention import flash_attention as kern
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch import train
from repro_torch.models import attention
from repro_torch.optim.adamw import AdamWConfig

pytestmark = pytest.mark.cuda

FWD = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
BWD_REL = 1e-3
# (b, s, h, kv, d, causal, window, prefix): the JAX kernel test's cases;
# gemma3-1b's training shapes (global and window 512); a ragged length;
# head dims that are not a multiple of 32
SHAPES = [
    (2, 128, 4, 2, 32, True, 0, 0),
    (1, 128, 8, 1, 16, True, 0, 0),
    (2, 64, 4, 4, 32, False, 0, 0),
    (1, 128, 4, 2, 16, True, 40, 0),
    (1, 128, 4, 2, 16, True, 0, 24),
    (1, 128, 4, 2, 16, True, 24, 16),
    (2, 2048, 4, 1, 256, True, 512, 0),
    (2, 2048, 4, 1, 256, True, 0, 0),
    (1, 100, 2, 1, 40, True, 30, 5),
    (2, 77, 6, 2, 200, False, 20, 0),
    (1, 96, 2, 2, 96, True, 0, 0),
    (1, 64, 2, 1, 30, True, 0, 0),       # d % 4 != 0: element loads
]
GEMMA_SHAPES = {"local": SHAPES[6], "global": SHAPES[7]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(b, s, h, kv, d, device, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device=device, dtype=dtype)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def _ids(shape):
    return "b{}s{}h{}kv{}d{}c{}w{}p{}".format(*[int(x) for x in shape])


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_forward_f32(cuda, shape):
    b, s, h, kv, d, causal, win, pre = shape
    q, k, v = inputs(b, s, h, kv, d, cuda)
    out, lse = kern.flash_attention_fwd_cuda(q, k, v, causal, win, pre)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, causal, win,
                                                        pre), **FWD)
    assert lse.shape == (b, h, s) and bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SHAPES[6]],
                         ids=_ids)
def test_forward_bf16(cuda, shape):
    b, s, h, kv, d, causal, win, pre = shape
    q, k, v = inputs(b, s, h, kv, d, cuda, torch.bfloat16, seed=1)
    out, _ = kern.flash_attention_fwd_cuda(q, k, v, causal, win, pre)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), flash_attention_ref(
        q, k, v, causal, win, pre).float(), **BF16)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_backward_f32(cuda, shape):
    b, s, h, kv, d, causal, win, pre = shape
    q, k, v = inputs(b, s, h, kv, d, cuda, seed=2)
    w = inputs(b, s, h, h, d, cuda, seed=3)[0]
    grads = []
    for fn in (lambda *a: ops.flash_attention(*a, causal, win, pre),
               lambda *a: flash_attention_ref(*a, causal, win, pre)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        torch.sum(fn(*leaves) * w).backward()
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        gap = (got - want).abs().max().item()
        assert gap <= BWD_REL * want.abs().max().item(), gap


def _rel_gap(got, want):
    gap = (got - want).abs().max().item()
    assert gap <= BWD_REL * want.abs().max().item(), gap


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1], SHAPES[2],
                                   SHAPES[5], SHAPES[8]], ids=_ids)
def test_backward_kernels_against_their_plain_versions(cuda, shape):
    """Each backward kernel on the same inputs as its plain version (the
    kernel forward's output and log-sum-exp), one launch each."""
    b, s, h, kv, d, causal, win, pre = shape
    q, k, v = inputs(b, s, h, kv, d, cuda, seed=6)
    dout = inputs(b, s, h, h, d, cuda, seed=7)[0]
    mask = (causal, win, pre)
    o, lse = kern.flash_attention_fwd_cuda(q, k, v, *mask)
    before = dict(kern.LAUNCHES)
    dq, delta = kern.flash_attention_bwd_dq_cuda(q, k, v, o, lse, dout,
                                                 *mask)
    dk_p, dv_p = kern.flash_attention_bwd_dkv_cuda(q, k, v, lse, delta, dout,
                                                   *mask)
    dk, dv = kern.flash_attention_bwd_sum_cuda(dk_p, dv_p, kv)
    torch.cuda.synchronize()
    assert {n: kern.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1, "flash_attention_bwd_sum": 1}
    want_dq, want_delta = ref.flash_attention_bwd_dq_ref(q, k, v, o, lse,
                                                         dout, *mask)
    torch.testing.assert_close(delta, want_delta, rtol=1e-6, atol=1e-6)
    _rel_gap(dq, want_dq)
    want_dk, want_dv = ref.flash_attention_bwd_dkv_ref(q, k, v, lse, delta,
                                                       dout, *mask)
    _rel_gap(dk_p, want_dk)
    _rel_gap(dv_p, want_dv)
    for got, want in zip((dk, dv), ref.flash_attention_bwd_sum_ref(
            dk_p, dv_p, kv)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# The dK/dV pass on the tensor cores (32 x 32 key and query tiles, columns
# padded to 32, 64, 128 or 256): lengths ragged for both tiles, rep = 1
# (the direct (b, s, kv, d) write), D = 8 and D = 256, a window and a
# prefix
DKV_SHAPES = [
    (2, 77, 4, 2, 64, True, 0, 0),
    (1, 100, 2, 2, 128, True, 30, 0),
    (1, 70, 4, 1, 8, True, 0, 5),
    (1, 160, 2, 1, 256, True, 48, 0),
    (2, 50, 2, 2, 256, False, 0, 0),
]


def _dkv_inputs(shape, seed):
    """Inputs of the dK/dV pass: q, k, v, dout and the kernel forward's
    log-sum-exp and the dQ pass's delta."""
    b, s, h, kv, d, causal, win, pre = shape
    q, k, v = inputs(b, s, h, kv, d, torch.device("cuda"), seed=seed)
    dout = inputs(b, s, h, h, d, torch.device("cuda"), seed=seed + 1)[0]
    o, lse = kern.flash_attention_fwd_cuda(q, k, v, causal, win, pre)
    _, delta = kern.flash_attention_bwd_dq_cuda(q, k, v, o, lse, dout,
                                                causal, win, pre)
    return q, k, v, lse, delta, dout


def _dkv_simt(q, k, v, lse, delta, dout, causal, win, pre):
    """The CUDA-core yardstick (C symbol flash_bwd_dkv_simt), which no
    wrapper calls, on the same inputs."""
    b, s, h, d = q.shape
    lib = kern._library()
    fn = lib.flash_bwd_dkv_simt
    fn.argtypes = lib.flash_bwd_dkv.argtypes
    fn.restype = lib.flash_bwd_dkv.restype
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, k.shape[2], d, int(causal), win, pre,
            torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return dk, dv


@pytest.mark.parametrize("shape", DKV_SHAPES, ids=_ids)
def test_dkv_pass_against_its_plain_version(cuda, shape):
    """The tensor-core dK/dV pass within BWD_REL of its plain version at
    shapes its tiles do not divide, and one launch per call."""
    causal, win, pre = shape[5:]
    args = _dkv_inputs(shape, seed=8)
    before = kern.LAUNCHES["flash_attention_bwd_dkv"]
    dk, dv = kern.flash_attention_bwd_dkv_cuda(*args, causal, win, pre)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["flash_attention_bwd_dkv"] == before + 1
    want_dk, want_dv = ref.flash_attention_bwd_dkv_ref(*args, causal, win,
                                                       pre)
    _rel_gap(dk, want_dk)
    _rel_gap(dv, want_dv)


def test_dkv_pass_repeats_bit_for_bit(cuda):
    """No atomics: two launches on the same inputs give the same bits."""
    shape = GEMMA_SHAPES["global"]
    args = _dkv_inputs(shape, seed=9)
    first = kern.flash_attention_bwd_dkv_cuda(*args, *shape[5:])
    second = kern.flash_attention_bwd_dkv_cuda(*args, *shape[5:])
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("label", sorted(GEMMA_SHAPES))
def test_dkv_pass_against_the_cuda_core_yardstick(cuda, label):
    """The tensor-core pass and the CUDA-core kernel it replaced, kept in
    the same library, within BWD_REL of each other at gemma3-1b's
    shapes."""
    shape = GEMMA_SHAPES[label]
    args = _dkv_inputs(shape, seed=10)
    got = kern.flash_attention_bwd_dkv_cuda(*args, *shape[5:])
    want = _dkv_simt(*args, *shape[5:])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _rel_gap(g, w)


# The dQ pass on the tensor cores (32-query blocks streaming 32-key tiles,
# columns padded to 32, 64, 128 or 256): lengths ragged for 32-row tiles,
# rep = 1, D = 8, 40, 200 and 256, a window and a prefix
DQ_SHAPES = [
    (2, 77, 4, 2, 64, True, 0, 0),
    (1, 100, 2, 2, 40, True, 30, 0),
    (1, 70, 4, 1, 8, True, 0, 5),
    (1, 160, 2, 1, 256, True, 48, 0),
    (2, 50, 2, 2, 256, False, 0, 0),
    (2, 77, 6, 2, 200, False, 20, 0),
]


def _dq_inputs(shape, seed):
    """Inputs of the dQ pass: q, k, v, the kernel forward's output and
    log-sum-exp, and dout."""
    b, s, h, kv, d, causal, win, pre = shape
    q, k, v = inputs(b, s, h, kv, d, torch.device("cuda"), seed=seed)
    dout = inputs(b, s, h, h, d, torch.device("cuda"), seed=seed + 1)[0]
    o, lse = kern.flash_attention_fwd_cuda(q, k, v, causal, win, pre)
    return q, k, v, o, lse, dout


def _dq_simt(q, k, v, o, lse, dout, causal, win, pre):
    """The CUDA-core yardstick (C symbol flash_bwd_dq_simt), which no
    wrapper calls, on the same inputs."""
    b, s, h, d = q.shape
    lib = kern._library()
    fn = lib.flash_bwd_dq_simt
    fn.argtypes = lib.flash_bwd_dq.argtypes
    fn.restype = lib.flash_bwd_dq.restype
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            b, s, h, k.shape[2], d, int(causal), win, pre,
            torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return dq, delta


@pytest.mark.parametrize("shape", DQ_SHAPES, ids=_ids)
def test_dq_pass_against_its_plain_version(cuda, shape):
    """The tensor-core dQ pass within BWD_REL of its plain version, and
    delta within rtol 1e-6, at shapes its tiles do not divide; one launch
    per call."""
    causal, win, pre = shape[5:]
    args = _dq_inputs(shape, seed=11)
    before = kern.LAUNCHES["flash_attention_bwd_dq"]
    dq, delta = kern.flash_attention_bwd_dq_cuda(*args, causal, win, pre)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["flash_attention_bwd_dq"] == before + 1
    want_dq, want_delta = ref.flash_attention_bwd_dq_ref(*args, causal, win,
                                                         pre)
    torch.testing.assert_close(delta, want_delta, rtol=1e-6, atol=1e-6)
    _rel_gap(dq, want_dq)


def test_dq_pass_repeats_bit_for_bit(cuda):
    """No atomics: two launches on the same inputs give the same bits."""
    shape = GEMMA_SHAPES["global"]
    args = _dq_inputs(shape, seed=12)
    first = kern.flash_attention_bwd_dq_cuda(*args, *shape[5:])
    second = kern.flash_attention_bwd_dq_cuda(*args, *shape[5:])
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("label", sorted(GEMMA_SHAPES))
def test_dq_pass_against_the_cuda_core_yardstick(cuda, label):
    """The tensor-core dQ pass and the CUDA-core kernel it replaced, kept
    in the same library, within BWD_REL of each other at gemma3-1b's
    shapes; delta is the same computation in both, bit for bit."""
    shape = GEMMA_SHAPES[label]
    args = _dq_inputs(shape, seed=13)
    dq, delta = kern.flash_attention_bwd_dq_cuda(*args, *shape[5:])
    want_dq, want_delta = _dq_simt(*args, *shape[5:])
    torch.cuda.synchronize()
    _rel_gap(dq, want_dq)
    assert torch.equal(delta, want_delta)


def test_attention_block_ragged_length_launches_the_kernel(cuda):
    """The attention block on the "cuda" route launches the kernel at a
    length its block does not divide (100 rows, block 64), forward and
    backward, and agrees with the "jnp" route within FWD."""
    b, s, d_model, h, kv, hd = 2, 100, 64, 4, 2, 32
    gen = torch.Generator().manual_seed(0)
    p = {n: t.to(cuda) for n, t in attention.attention_init(
        gen, d_model, h, kv, hd, qk_norm=True).items()}
    x = torch.randn((b, s, d_model), generator=gen).to(cuda)
    pos = torch.arange(s, device=cuda)[None].expand(b, s)
    kw = dict(window=24, block=64)
    want = attention.attention_block(p, x, pos, h, kv, hd, 1e4,
                                     backend="jnp", **kw)
    kern.reset_launches()
    xg = x.clone().requires_grad_(True)
    got = attention.attention_block(p, xg, pos, h, kv, hd, 1e4,
                                    backend="cuda", **kw)
    got.sum().backward()
    torch.cuda.synchronize()
    assert kern.LAUNCHES == {"flash_attention_fwd": 1,
                             "flash_attention_bwd_dq": 1,
                             "flash_attention_bwd_dkv": 1,
                             "flash_attention_bwd_sum": 1}
    torch.testing.assert_close(got.detach(), want, **FWD)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_rows_take_element_loads(cuda, dtype):
    """Contiguous tensors whose data starts 4 bytes (bf16: 2 bytes) off a
    16-byte boundary: the kernels load element by element, with the same
    result."""
    shape = (1, 128, 4, 2, 32, True, 24, 0)
    b, s, h, kv, d, causal, win, pre = shape
    q, k, v = inputs(b, s, h, kv, d, cuda, dtype, seed=4)
    off = [torch.empty(t.numel() + 1, dtype=dtype, device=cuda)[1:]
           .view(t.shape).copy_(t) for t in (q, k, v)]
    assert off[0].data_ptr() % 16
    got, _ = kern.flash_attention_fwd_cuda(*off, causal, win, pre)
    want, _ = kern.flash_attention_fwd_cuda(q, k, v, causal, win, pre)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if dtype == torch.float32:
        dout = inputs(b, s, h, h, d, cuda, seed=5)[0]
        o, lse = want, kern.flash_attention_fwd_cuda(q, k, v, causal, win,
                                                     pre)[1]
        ref = kern.flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal,
                                            win, pre)
        dout_off = torch.empty(dout.numel() + 1, device=cuda)[1:].view(
            dout.shape).copy_(dout)
        got = kern.flash_attention_bwd_cuda(*off, o, lse, dout_off, causal,
                                            win, pre)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_training_step_launch_counts(cuda):
    """One reduced-gemma3 training step on the card: per layer one launch
    of the forward kernel and one of each backward kernel (gemma3 has GQA,
    so the head sum runs); its loss equals the "jnp" route's within rtol
    1e-5."""
    cfg = dataclasses.replace(
        get_config("gemma3-1b").reduced(num_layers=2, d_model=64, vocab=512),
        attn_backend="cuda")
    batch = train.batch_to_device(lm_batch(
        DataConfig(vocab_size=512, seq_len=128, global_batch=2), cfg, 0),
        cuda)
    state = train.init_state(cfg, 0, device=cuda)
    loss_jnp, _, _ = train.loss_and_grads(
        state["params"], dataclasses.replace(cfg, attn_backend="jnp"), batch)
    kern.reset_launches()
    state, metrics = train.make_train_step(cfg, AdamWConfig())(state, batch)
    torch.cuda.synchronize()
    assert kern.LAUNCHES == {name: cfg.num_layers for name in kern.LAUNCHES}
    torch.testing.assert_close(metrics["loss"], loss_jnp, rtol=1e-5, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = inputs(1, 64, 4, 2, 32, cuda)
    with pytest.raises(ValueError):          # d above 256
        kern.flash_attention_fwd_cuda(*inputs(1, 8, 2, 1, 320, cuda))
    with pytest.raises(ValueError):          # h not a multiple of kv
        kern.flash_attention_fwd_cuda(*inputs(1, 8, 3, 2, 32, cuda))
    with pytest.raises(ValueError):          # float16
        kern.flash_attention_fwd_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):          # not contiguous
        kern.flash_attention_fwd_cuda(q.transpose(1, 2).contiguous()
                                      .transpose(1, 2), k, v)
    with pytest.raises(ValueError):          # mixed dtypes
        kern.flash_attention_fwd_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError):          # negative window
        kern.flash_attention_fwd_cuda(q, k, v, window=-1)
    with pytest.raises(ValueError):          # a CPU tensor among them
        kern.flash_attention_fwd_cuda(q, k.cpu(), v)
    qb = q.bfloat16().requires_grad_(True)
    out = kern.flash_attention_cuda(qb, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError):          # the backward is float32 only
        out.float().sum().backward()
    with pytest.raises(ValueError):          # 4 heads do not sum into 3
        kern.flash_attention_bwd_sum_cuda(q, q, 3)
    with pytest.raises(ValueError):          # dv_part of another shape
        kern.flash_attention_bwd_sum_cuda(q, k, 2)


@pytest.mark.parametrize("b,s,h,kv,d", ((2, 2048, 4, 1, 256), (2, 77, 6, 2, 200),
                                        (1, 64, 2, 1, 30), (1, 100, 8, 2, 40),
                                        (3, 5, 4, 4, 16)))
def test_head_sum_equals_head_order_adds(cuda, b, s, h, kv, d):
    """The head sum (16-byte pieces where D % 4 == 0, 4-byte ones else)
    equals float32 adds in head order from 0 bit for bit, and lies within
    rtol 1e-6 of torch.sum."""
    gen = torch.Generator(device=cuda).manual_seed(b * s + d)
    dk_p, dv_p = (torch.randn((b, s, h, d), generator=gen, device=cuda)
                  for _ in range(2))
    got = kern.flash_attention_bwd_sum_cuda(dk_p, dv_p, kv)
    want = ref.flash_attention_bwd_sum_ordered(dk_p, dv_p, kv)
    sums = ref.flash_attention_bwd_sum_ref(dk_p, dv_p, kv)
    for g, w, t in zip(got, want, sums):
        assert g.shape == (b, s, kv, d) and torch.equal(g, w)
        assert (g - t).abs().max().item() <= 1e-6 * t.abs().max().item()
