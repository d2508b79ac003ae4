"""The mesh on the card: two ranks sharing one GPU over gloo
(``repro_torch.launch.mesh`` picks gloo when ranks share a card), each
holding its slice of the split plans. Column and row splits at qwen3-4b's
projection shapes, expert splits of a moonshot expert stack, on
``exact-cuda`` (and ``analog-cuda`` for the experts), and one full-width
layer tree of whisper-medium (with its cross-attention) and of
paligemma-3b placed as serving places it, equal the unsplit plans bit for
bit; the row splits launch B2 (the PIM matmul kernel's
int32 entry point) on each rank's K block, once per call, and it equals
its plain version. Every test needs an NVIDIA GPU and nvcc and skips
without them; this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_mesh.py
"""
import multiprocessing
import queue

import pytest
import torch

from repro_torch.kernels import runtime

import torch_mesh_worker as worker

pytestmark = pytest.mark.cuda

RANKS = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _run_on_ranks(tmp_path, name, **kwargs):
    """Spawn the ranks on the card, run one request, return the replies."""
    runtime.build_all(["pim_matmul", "analog_readout"])  # before any rank
    ctx = multiprocessing.get_context("spawn")
    inboxes = [ctx.Queue() for _ in range(RANKS)]
    outbox = ctx.Queue()
    procs = [ctx.Process(target=worker.serve_rank, args=(
        r, RANKS, str(tmp_path / "init"), inboxes[r], outbox, "cuda"))
        for r in range(RANKS)]
    for p in procs:
        p.start()
    try:
        for box in inboxes:
            box.put((name, kwargs))
        replies = {}
        while len(replies) < RANKS:
            rank, status, value = outbox.get(timeout=300)
            assert status == "ok", f"rank {rank}: {value}"
            replies[rank] = value
        for box in inboxes:
            box.put(None)
        for p in procs:
            p.join(timeout=60)
    except queue.Empty:
        raise AssertionError(f"{name}: a rank gave no reply") from None
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [replies[r] for r in range(RANKS)]


def test_splits_on_the_card_bit_exact(cuda, tmp_path):
    for got in _run_on_ranks(tmp_path, "cuda_splits"):
        assert got["backend"] == "gloo" and got["device"] == "cuda:0"
        assert got["equal"] and all(got["equal"].values()), got["equal"]
        for case, routes in got["routes"].items():
            m = int(case.split()[1].split("x")[0])
            route = "small_m" if m <= 64 else "wgmma"
            name, other = ("pim_matmul_int", "pim_matmul_fused") \
                if case.startswith("row") else \
                ("pim_matmul_fused", "pim_matmul_int")
            assert routes[name] == {route: 1}, (case, routes)
            assert not routes[other], (case, routes)


def test_family_layer_splits_on_the_card_bit_exact(cuda, tmp_path):
    """whisper-medium's and paligemma-3b's layer trees at full width: every
    split plan equals its whole plan on exact-cuda, at the (K, N) each
    rank's kernel sees: whisper's columns N 512 (q, k, v of both
    attentions) and 2048 (the MLP's up), rows K 512 and 2048; paligemma's
    columns N 1024, 128 (its one KV head's k and v) and 8192, rows K 1024
    and 8192."""
    for got in _run_on_ranks(tmp_path, "cuda_family_splits"):
        assert got["equal"] and all(got["equal"].values()), got["equal"]
        shapes = {tuple(s) for s in got["shapes"]}
        assert shapes == {
            ("col", 1024, 512), ("col", 1024, 2048), ("row", 512, 1024),
            ("row", 2048, 1024),
            ("col", 2048, 1024), ("col", 2048, 128), ("col", 2048, 8192),
            ("row", 1024, 2048), ("row", 8192, 2048)}, shapes
