"""The rank side of ``tests/test_torch_mesh.py``,
``tests/test_torch_cuda_mesh.py`` and the sharded-training tests
(``tests/test_torch_train_mesh.py``, ``tests/test_torch_cuda_train_mesh.py``):
a process of a gloo group (on the CPU,
or sharing the card) that runs the functions below on request, each rank
the same one with the same arguments, and sends back what it returns.
Imports no JAX (the CPU test's parent holds the JAX side and compares).

``serve_rank`` is the process's target; a request is ``(name, kwargs)``
and the reply ``(rank, "ok", value)`` or ``(rank, "error", traceback)``.
"""
import os
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import engine
from repro_torch.checkpoint import ckpt
from repro_torch.core import pim
from repro_torch.core.pim import PimConfig
from repro_torch.distributed.sharding import ShardingContext, use_sharding
from repro_torch.engine import mesh as mesh_mod
from repro_torch.engine import persist
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import train
from repro_torch.models import moe
from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_grads, compress_leaf
from repro_torch.tree import flatten_with_path, leaves, tree_map

_MESHES = {}
_DEVICE = {"device": "cpu"}


def _mesh(spec):
    """One mesh per spec, built on first use (collective: every rank runs
    the same requests in the same order)."""
    if spec not in _MESHES:
        _MESHES[spec] = launch_mesh.make_serve_mesh(spec, _DEVICE["device"])
    return _MESHES[spec]


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _own(tree):
    """``tree`` with every tensor copied into this process's memory. A
    request's CPU tensors arrive in storage that torch's multiprocessing
    reductions share with the parent and with every other rank (the
    parent's tensor is moved to shared memory when it is queued), so a
    request that updates its arguments in place (a train step on a
    replicated leaf) would otherwise update every rank's copy at once."""
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)


def serve_rank(rank, world, init_file, inbox, outbox, device="cpu"):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    _DEVICE["device"] = device
    launch_mesh.init_distributed(device, f"file://{init_file}", rank, world)
    try:
        while True:
            request = inbox.get()
            if request is None:
                break
            name, kwargs = request
            try:
                kwargs = {k: _own(v) for k, v in kwargs.items()}
                outbox.put((rank, "ok", globals()[name](**kwargs)))
            except Exception:  # noqa: BLE001: the parent reports it
                outbox.put((rank, "error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------
def dense_splits(substrate, bits, spec="2,2"):
    """Column (with a bias) and row splits of one (K, N) plan against the
    unsplit plan, at an M the data axis divides and one it does not:
    {case: bit-identical}."""
    mesh = _mesh(spec)
    cfg = PimConfig(weight_bits=bits, act_bits=bits, substrate=substrate)
    w, bias = _rand((96, 40), 1), _rand((40,), 2)
    full = engine.program(w, cfg)
    out = {}
    for kind in ("col", "row"):
        plan = engine.program(w, cfg, mesh=mesh, spec=kind)
        assert plan.shard.kind == kind and plan.abft is None
        b = bias if kind == "col" else None
        for m in (6, 5):
            x = _rand((m, 96), 3 + m)
            out[f"{kind} m={m}"] = torch.equal(
                engine.matmul(x, plan, bias=b),
                engine.matmul(x, full, bias=b))
    return out


def emulate_col(spec="2,2"):
    """``emulate`` column split against the unsplit plan: (max abs gap,
    max abs output)."""
    mesh = _mesh(spec)
    cfg = PimConfig(substrate="emulate")
    w, x = _rand((256, 96), 4), _rand((6, 256), 5)
    want = engine.matmul(x, engine.program(w, cfg))
    got = engine.matmul(x, engine.program(w, cfg, mesh=mesh, spec="col"))
    return float((got - want).abs().max()), float(want.abs().max())


def expert_split(substrate, paired, spec="2,2"):
    mesh = _mesh(spec)
    cfg = PimConfig(substrate=substrate)
    w = _rand((4, 48, 24), 6)
    x = _rand((4, 5, 48) if paired else (5, 48), 7)
    full = engine.program(w, cfg, kind="experts")
    plan = engine.program(w, cfg, kind="experts", mesh=mesh)
    assert plan.dense.values.shape[0] == 2 and plan.num_experts == 4
    return torch.equal(engine.matmul(x, plan, paired=paired),
                       engine.matmul(x, full, paired=paired))


def refusals(spec="2,2"):
    """{case: the split raised as the reference's does}."""
    mesh = _mesh(spec)
    out = {}

    def raises(name, exc, fn):
        try:
            fn()
        except exc:
            out[name] = True
        else:
            out[name] = False

    w = _rand((32, 16), 8)
    for kind in ("col", "row"):
        raises(f"analog {kind}", ValueError, lambda: engine.program(
            w, PimConfig(substrate="analog"), mesh=mesh, spec=kind))
    raises("odd n", ValueError, lambda: engine.program(
        _rand((32, 15), 9), PimConfig(substrate="exact-torch"), mesh=mesh))
    raises("odd e", ValueError, lambda: engine.program(
        _rand((3, 32, 16), 10), PimConfig(substrate="exact-torch"),
        kind="experts", mesh=mesh))
    raises("spec without mesh", ValueError, lambda: engine.program(
        w, PimConfig(), spec="col"))
    plan = engine.program(w, PimConfig(substrate="exact-torch"), mesh=mesh)
    raises("rng", NotImplementedError, lambda: engine.matmul(
        _rand((2, 32), 11), plan, rng=torch.Generator()))
    raises("paired dense", ValueError, lambda: engine.matmul(
        _rand((2, 32), 11), plan, paired=True))
    # the tree walk replicates what does not split
    tree = mesh_mod.place_plan_tree(
        {"wq_dh": engine.program(_rand((32, 15), 9),
                                 PimConfig(substrate="exact-torch"))},
        mesh)[1]
    out["odd n replicated by the tree walk"] = tree == ["wq_dh"]
    return out


def moe_pim_split(substrate, chunk_elements, spec="2,2"):
    """``moe._moe_pim`` on expert-split stacks against the unsplit stacks,
    with chunks that straddle the ranks' expert blocks: bit-identical."""
    mesh = _mesh(spec)
    cfg = PimConfig(substrate=substrate)
    e, d, f, t = 8, 32, 24, 6
    stacks = [engine.program(_rand(shape, 20 + i), cfg, kind="experts")
              for i, shape in enumerate(((e, d, f), (e, d, f), (e, f, d)))]
    split = [mesh_mod.shard_plan(p, mesh) for p in stacks]
    x = _rand((t, d), 23)
    g = np.random.default_rng(24)
    ids = torch.from_numpy(np.stack([g.choice(e, 2, replace=False)
                                     for _ in range(t)]))
    probs = torch.softmax(_rand((t, 2), 25), -1)
    saved = moe.PIM_CHUNK_ELEMENTS
    moe.PIM_CHUNK_ELEMENTS = chunk_elements
    try:
        want = moe._moe_pim(x, probs, ids, *stacks)
        got = moe._moe_pim(x, probs, ids, *split)
    finally:
        moe.PIM_CHUNK_ELEMENTS = saved
    return torch.equal(got, want)


def moe_ep(params, x, k, spec):
    """``moe_apply`` on float stacks under a sharding context: the
    expert-parallel branch's output, and the same branch with a capacity
    that drops nothing against ``_moe_local`` (max abs gap)."""
    mesh = _mesh(spec)
    p = {name: torch.from_numpy(v) for name, v in params.items()}
    xt = torch.from_numpy(x)
    with use_sharding(ShardingContext(mesh)):
        out = moe.moe_apply(p, xt, k)
    x2 = xt.reshape(-1, xt.shape[-1])
    probs, ids, _, _ = moe._route(p["router_de"], x2, k)
    e = p["wi_edf"].shape[0]
    ep = mesh.shape["model"]
    own = e // ep
    mine = slice(mesh.coords["model"] * own, (mesh.coords["model"] + 1) * own)
    part = moe._moe_ep_body(x2, probs, ids, p["wi_edf"][mine],
                            p["wg_edf"][mine], p["wo_efd"][mine],
                            num_experts=e, shard=mesh.coords["model"],
                            capacity_factor=float(ep))
    nodrop = mesh_mod.all_reduce(part, mesh, "model")
    local = moe._moe_local(x2, probs, ids, p["wi_edf"], p["wg_edf"],
                           p["wo_efd"], e)
    return out.numpy(), float((nodrop - local).abs().max())


# ---------------------------------------------------------------------------
# plan directories
# ---------------------------------------------------------------------------
def _tree(cfg, layers=2):
    """A small planned tree in the serving form: per-layer lists of plans
    (two dense projections, an expert stack) and a float leaf."""
    def proj(shape, seed):
        return [engine.program(_rand(shape, seed + i), cfg)
                for i in range(layers)]
    return {"layers": {"attn": {"wq_dh": proj((64, 48), 30),
                                "wo_hd": proj((48, 64), 40)},
                       "moe": {"wi_edf": [engine.program(
                           _rand((4, 64, 32), 50 + i), cfg, kind="experts")
                           for i in range(layers)]}},
            "embed_vd": _rand((16, 64), 60)}


def _outputs(tree):
    """Every plan's output on fixed inputs, by path."""
    out = {}
    x = _rand((6, 64), 70)
    xh = _rand((6, 48), 71)
    for name, plans in (("wq_dh", tree["layers"]["attn"]["wq_dh"]),
                        ("wo_hd", tree["layers"]["attn"]["wo_hd"]),
                        ("wi_edf", tree["layers"]["moe"]["wi_edf"])):
        for i, plan in enumerate(plans):
            out[f"{name}.{i}"] = engine.matmul(
                xh if name == "wo_hd" else x, plan).numpy()
    return out


def write_stamped(directory, spec="2,2"):
    """Program the tree, split it over the mesh and save it (rank 0
    writes). Returns the unsplit outputs, whether the split ones equal
    them, and the stamps of the tree's spec."""
    mesh = _mesh(spec)
    cfg = PimConfig(substrate="exact-torch")
    full = _tree(cfg)
    split = engine.shard_plan_tree(_tree(cfg), mesh)
    want, got = _outputs(full), _outputs(split)
    engine.save_plans(directory, split, extras={"mesh": spec})
    return {"outputs": want,
            "split_equal": all(np.array_equal(got[k], want[k])
                               for k in want),
            "stamps": persist._shard_stamps(persist.describe_plan_tree(
                split))}


def save_fails(directory, partway, spec="2,2"):
    """``save_plans`` of a split tree where rank 0's write fails: at its
    directory (``directory`` lies under a regular file) or, with
    ``partway``, at the third leaf (a full disk). Returns what this rank
    raised and the sum of ones over the group afterwards (the world size
    when the ranks' collectives stayed paired)."""
    mesh = _mesh(spec)
    split = engine.shard_plan_tree(_tree(PimConfig(substrate="exact-torch")),
                                   mesh)
    write_array, calls = np.lib.format.write_array, [0]

    def full_disk(*args, **kwargs):
        calls[0] += 1
        if calls[0] == 3:
            raise OSError(28, "No space left on device")
        return write_array(*args, **kwargs)

    if partway:
        np.lib.format.write_array = full_disk
    try:
        engine.save_plans(directory, split)
        raised = None
    except OSError as e:
        raised = f"{type(e).__name__}: {e}"
    finally:
        np.lib.format.write_array = write_array
    ones = torch.ones(1)
    dist.all_reduce(ones)
    return {"raised": raised, "after": float(ones)}


def _kinds(tree, path=""):
    """(path, shard kind or None) of every plan in a restored tree."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _kinds(
            tree[k], f"{path}/{k}" if path else k)]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _kinds(v, f"{path}[{i}]")]
    if isinstance(tree, pim.Plan):
        shard = getattr(tree, "shard", None)
        return [(path, None if shard is None else shard.kind)]
    return []


def load_stamped(directory, spec="2,2", own_tree=True):
    """Restore a stamped directory with ``mesh=`` (each rank its slices)
    and without (whole plans, a warning): the kinds restored with the
    mesh, and the outputs of both (equal to each other, and, for the
    directory ``write_stamped`` writes, to the tree it split)."""
    mesh = _mesh(spec)
    placed, _, extras = engine.load_plans(directory, mesh=mesh)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        whole, _, _ = engine.load_plans(directory, device="cpu")
    warned = any("shard stamp" in str(w.message) for w in caught)
    out = {"kinds": _kinds(placed), "warned": warned,
           "whole_kinds": _kinds(whole), "extras": extras}
    if own_tree:
        want = _outputs(_tree(PimConfig(substrate="exact-torch")))
        got, got_whole = _outputs(placed), _outputs(whole)
        out["equal"] = all(np.array_equal(got[k], want[k]) and
                           np.array_equal(got_whole[k], want[k])
                           for k in want)
    else:
        out["equal"] = _equal_everywhere(placed, whole)
    return out


def _equal_everywhere(placed, whole):
    """Every plan of two restores of one directory gives the same output
    on a fixed input of its K."""
    pairs = []

    def walk(a, b):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            for u, v in zip(a, b):
                walk(u, v)
        elif isinstance(a, pim.Plan):
            pairs.append((a, b))
    walk(placed, whole)
    ok = True
    for i, (a, b) in enumerate(pairs):
        x = _rand((6, b.shape[-2]), 80 + i)
        ok &= torch.equal(engine.matmul(x, a), engine.matmul(x, b))
    return ok and bool(pairs)


def serve_mesh(kwargs):
    """``serve_continuous`` on the mesh: its token streams and mesh
    fields."""
    from repro_torch.launch import serve
    res = serve.serve_continuous(**kwargs)
    return {"tokens": {r["id"]: np.asarray(r["tokens"]).tolist()
                       for r in res["requests"]},
            "mesh": res.get("mesh"), "backend": res.get("mesh_backend"),
            "ranks": res.get("mesh_ranks"), "pid": os.getpid()}


def serve_static_mesh(kwargs):
    """``serve`` (the static loop) on the mesh: its tokens and mesh
    fields."""
    from repro_torch.launch import serve
    res = serve.serve(**kwargs)
    return {"generated": np.asarray(res["generated"]).tolist(),
            "mesh": res.get("mesh"), "backend": res.get("mesh_backend"),
            "ranks": res.get("mesh_ranks")}


def family_kinds(params, spec="2,2"):
    """``plan_params_for_pim`` of a float parameter tree on exact-torch,
    placed on the mesh: every plan's (path, kind), the names the walk
    replicated, and the float leaves outside the layer stacks (name ->
    shape), which stay whole."""
    from repro_torch.launch import serve
    mesh = _mesh(spec)
    planned = serve.plan_params_for_pim(params, PimConfig(
        weight_bits=4, act_bits=4, substrate="exact-torch"))
    placed, replicated = mesh_mod.place_plan_tree(planned, mesh)
    return {"kinds": _kinds(placed), "replicated": replicated,
            "floats": {k: list(v.shape) for k, v in placed.items()
                       if isinstance(v, torch.Tensor)}}


def serve_plan_dir(kwargs):
    """``serve`` on the mesh with ``plan_dir`` twice (programmed and saved,
    then restored), what rank 0 said each time, and the directory
    restored with ``load_plans(mesh=)``: its plans' kinds and extras."""
    import contextlib
    import io
    from repro_torch.launch import serve
    runs = []
    for _ in range(2):
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            res = serve.serve(**kwargs)
        runs.append({"generated": np.asarray(res["generated"]).tolist(),
                     "said": said.getvalue()})
    placed, _, extras = engine.load_plans(kwargs["plan_dir"],
                                          mesh=_mesh(kwargs["mesh"]))
    return {"runs": runs, "kinds": _kinds(placed),
            "extras_mesh": extras.get("mesh")}


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_cuda_mesh.py)
# ---------------------------------------------------------------------------
def cuda_splits(spec="1,2"):
    """Column, row and expert splits on exact-cuda at qwen3-4b's and
    moonshot's shapes (M = 512 and 8) against the unsplit plans, bit for
    bit; B2's launches by route over the row splits; B2 on a rank's K block
    against its plain version. Returns {case: equal} and the counts."""
    from repro_torch.kernels.pim_matmul import pim_matmul as kern
    from repro_torch.kernels.pim_matmul.ref import pim_matmul_ref
    mesh = _mesh(spec)
    dev = mesh.device
    cfg = PimConfig(substrate="exact-cuda")
    out, routes = {}, {}
    for k, n, kind in ((2560, 4096, "col"), (2560, 9728, "col"),
                       (4096, 2560, "row"), (9728, 2560, "row")):
        w = _rand((k, n), k + n).to(dev)
        full = engine.program(w, cfg)
        split = engine.program(w, cfg, mesh=mesh, spec=kind)
        for m in (512, 8):
            x = _rand((m, k), m).to(dev)
            kern.reset_launches()
            got = engine.matmul(x, split)
            torch.cuda.synchronize()
            routes[f"{kind} {m}x{k}x{n}"] = {
                name: {r: c for r, c in kern.ROUTE_LAUNCHES[name].items()
                       if c} for name in kern.LAUNCHES}
            out[f"{kind} {m}x{k}x{n}"] = torch.equal(
                got, engine.matmul(x, full))
            if kind == "row":
                _, a_planes = pim._quantize_activations(x, cfg)
                width = split.planes.shape[-2]
                blk = mesh_mod.act_block(
                    a_planes, split.shard.index * width, width)
                out[f"B2 plain {m}x{k}x{n}"] = torch.equal(
                    kern.pim_matmul_cuda(blk, split.planes),
                    pim_matmul_ref(blk, split.planes))
    w = _rand((4, 2048, 1408), 9).to(dev)
    for substrate in ("exact-cuda", "analog-cuda"):
        c = PimConfig(substrate=substrate)
        full = engine.program(w, c, kind="experts")
        split = engine.program(w, c, kind="experts", mesh=mesh)
        for paired in (False, True):
            x = _rand((4, 64, 2048) if paired else (64, 2048), 10).to(dev)
            out[f"expert {substrate} paired={paired}"] = torch.equal(
                engine.matmul(x, split, paired=paired),
                engine.matmul(x, full, paired=paired))
    return {"equal": out, "routes": routes, "backend": mesh.backend,
            "device": str(dev)}


def cuda_family_splits(spec="1,2"):
    """One full-width layer tree of whisper-medium (a decoder layer, with
    its cross-attention) and of paligemma-3b, programmed on exact-cuda and
    placed on the mesh as serving places them: every split plan against
    its whole plan at M = 512 and 8, bit for bit. Returns {case: equal}
    and the (kind, K, N) of each rank's slices, as the kernel sees them."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    mesh = _mesh(spec)
    dev = mesh.device
    cfg = PimConfig(weight_bits=4, act_bits=4, substrate="exact-cuda")
    out, shapes = {}, set()
    for arch in ("whisper-medium", "paligemma-3b"):
        model = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(3)
        layer = lm._init_layer(model, gen, dev,
                               cross_attention=model.encoder_layers > 0)
        whole = serve.plan_layer(layer, cfg)
        del layer
        placed, replicated = mesh_mod.place_plan_tree(whole, mesh)
        assert not replicated, replicated
        wholes = dict(flatten_with_path(whole))
        for path, plan in flatten_with_path(placed):
            if not isinstance(plan, pim.DensePlan):
                continue
            name = "/".join(path)
            full = wholes[path]
            shapes.add((plan.shard.kind, *plan.planes.shape[-2:]))
            for m in (512, 8):
                x = _rand((m, plan.k), m).to(dev)
                out[f"{arch} {name} M={m}"] = torch.equal(
                    engine.matmul(x, plan), engine.matmul(x, full))
        del whole, placed
        torch.cuda.empty_cache()
    return {"equal": out, "shapes": sorted(shapes)}


# ---------------------------------------------------------------------------
# sharded training (tests/test_torch_train_mesh.py,
# tests/test_torch_cuda_train_mesh.py)
# ---------------------------------------------------------------------------
def _on(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def _named(tree):
    return {"/".join(path): t for path, t in flatten_with_path(tree)}


def _host(tree):
    return {k: v.detach().cpu().numpy() for k, v in _named(tree).items()}


def train_mesh_step(cfg, state, batch, opt, spec, compress_bits=0):
    """One sharded step from the global ``state`` (the port's tree, on the
    CPU) on ``batch`` (numpy): the loss, the gradient's global norm and
    the gathered gradient of the sharded loss-and-gradients, then one
    ``make_train_step(..., mesh=)`` step: its metrics, the gathered
    parameters after it, and this rank's replicated leaves (their bits,
    for the comparison across ranks). Flash-kernel launches by kernel
    over the two passes on the card."""
    mesh = _mesh(spec)
    dev = mesh.device
    from repro_torch.kernels.flash_attention import flash_attention as fkern
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    template = train.param_template(cfg)
    local = _on(train.shard_state(state, mesh), dev)
    fkern.reset_launches()
    grads_fn = train.sharded_loss_and_grads(cfg, mesh)
    loss, _, grads = grads_fn(local["params"], batch)
    gnorm = adamw.global_norm(grads, grads_fn.splits)
    whole = train.gather_state(grads, mesh, template)
    step = train.make_train_step(cfg, adamw.AdamWConfig(**opt),
                                 compress_bits, mesh)
    new, metrics = step(local, batch)
    launches = dict(fkern.LAUNCHES)
    params = train.gather_state(new["params"], mesh, template)
    split = dict(zip(_named(template), grads_fn.splits.split))
    mine = {k: v for k, v in _host(new["params"]).items() if not split[k]}
    return {"rank": mesh.rank, "coords": dict(mesh.coords),
            "device": str(dev), "backend": mesh.backend,
            "loss": float(loss), "grad_norm": float(gnorm),
            "step_loss": float(metrics["loss"]),
            "step_grad_norm": float(metrics["grad_norm"]),
            "grads": _host(whole), "params": _host(params),
            "replicated": mine, "split": split, "launches": launches,
            "step": int(new["step"])}


def train_compress_codes(cfg, state, batch, spec):
    """int8 compression on the mesh: {leaf: the gathered codes of a split
    leaf equal ``compress_leaf`` of the gathered gradient, codes and
    scale bit for bit}."""
    mesh = _mesh(spec)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    template = train.param_template(cfg)
    local = train.shard_state(state, mesh)
    grads_fn = train.sharded_loss_and_grads(cfg, mesh)
    _, _, grads = grads_fn(local["params"], batch)
    codes, scales, _ = compress_grads(grads, None, 8, grads_fn.splits)
    whole_codes = train.gather_state(codes, mesh, template)
    whole_grads = train.gather_state(grads, mesh, template)
    out = {}
    for name, is_split, c, s, g in zip(
            _named(template), grads_fn.splits.split, leaves(whole_codes),
            leaves(scales), leaves(whole_grads)):
        if is_split:
            want_c, want_s, _ = compress_leaf(g, None, 8)
            out[name] = torch.equal(c, want_c) and torch.equal(s, want_s)
    return out


def train_save(cfg, state, directory, spec, compress_bits=0):
    """Save this rank's slices of ``state`` as a mesh checkpoint."""
    mesh = _mesh(spec)
    specs = train.tree_specs(mesh, state)
    return ckpt.save_checkpoint(directory, 3, train.shard_state(state, mesh),
                                {"data_step": 3}, mesh=mesh, specs=specs)


def train_restore(cfg, state, directory, spec):
    """Restore a (single-process) checkpoint onto the mesh: whether every
    leaf equals this rank's slice of ``state`` bit for bit, and the
    step."""
    mesh = _mesh(spec)
    want = train.shard_state(state, mesh)
    blank = tree_map(torch.zeros_like, want)
    got, step, _ = ckpt.restore_checkpoint(
        directory, blank, mesh=mesh, specs=train.tree_specs(mesh, state))
    return step, all(torch.equal(a, b) for a, b in zip(leaves(got),
                                                       leaves(want)))


def train_save_fails(state, directory, spec):
    """A mesh checkpoint whose write fails on rank 0: the exception type
    every rank raises."""
    mesh = _mesh(spec)
    try:
        ckpt.save_checkpoint(directory, 1, train.shard_state(state, mesh),
                             mesh=mesh, specs=train.tree_specs(mesh, state))
    except OSError as e:
        return type(e).__name__
    return None
