"""Atomic step checkpoints (counterpart of ``repro/checkpoint/ckpt.py``),
in the same layout, so that a checkpoint written by either package
restores in the other:

    <dir>/step_000123/
        manifest.json   structure fingerprint, dtypes, shapes, per-leaf
                        sha256 of the stored bytes, step, extras
        arrays.npz      the leaves as leaf_00000, leaf_00001, ... in
                        ``jax.tree`` flatten order (bf16 as uint16 bits)
    <dir>/LATEST        the newest complete step directory

Data goes to ``step_X.tmp`` and is renamed when complete; ``LATEST`` is
replaced last, so a crash mid-write leaves the previous checkpoint the
latest. Leaves are gathered to the host and restored onto the template
leaf's device and dtype. The structure fingerprint renders each leaf's
key path as the JAX package does (:mod:`repro_torch.tree`).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, leaves, unflatten_like

PyTree = Any


class CheckpointCorruptionError(RuntimeError):
    """A stored leaf payload fails its manifest sha256 (bit-rot, torn
    write, tampering) or cannot be read back at all. ``leaf_index`` /
    ``leaf_name`` identify the offending entry in ``arrays.npz``."""

    def __init__(self, msg: str, leaf_index: Optional[int] = None,
                 leaf_name: Optional[str] = None) -> None:
        super().__init__(msg)
        self.leaf_index = leaf_index
        self.leaf_name = leaf_name


def _payload_sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def tree_fingerprint(tree: PyTree) -> str:
    """Stable fingerprint of a tree's structure: the ordered key paths of
    all leaves, rendered as the JAX package renders them."""
    rendered = "\n".join("/".join(path) for path, _ in
                         flatten_with_path(tree))
    return hashlib.sha256(rendered.encode()).hexdigest()[:16]


def _to_numpy(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor leaf -> (the array to store, the dtype name to record)."""
    t = x.detach().cpu()
    if t.dtype == torch.bfloat16:       # npz has no bf16: store raw bits
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree: PyTree,
                    extras: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = [_to_numpy(x) for x in leaves(tree)]
    names = [f"leaf_{i:05d}" for i in range(len(flat))]
    arrays = {n: arr for n, (arr, _) in zip(names, flat)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "treedef": tree_fingerprint(tree),
        "num_leaves": len(flat),
        "dtypes": [dtype for _, dtype in flat],
        "shapes": [list(arr.shape) for arr, _ in flat],
        "sha256": [_payload_sha256(arrays[n]) for n in names],
        "extras": extras or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    fd, tmp_latest = tempfile.mkstemp(dir=directory)
    with os.fdopen(fd, "w") as f:
        f.write(os.path.basename(final))
    os.replace(tmp_latest, os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[-1])


def _to_tensor(arr: np.ndarray, dtype_name: str,
               like: torch.Tensor) -> torch.Tensor:
    arr = np.array(arr, order="C")   # a copy; keeps 0-d arrays 0-d
    if dtype_name == "bfloat16" and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def restore_checkpoint(directory: str, template: PyTree,
                       step: Optional[int] = None
                       ) -> Tuple[PyTree, int, Dict[str, Any]]:
    """Restore into the structure of ``template`` (its tensor leaves give
    each restored leaf's device and dtype). Returns (tree, step,
    extras)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    flat_t = leaves(template)
    if len(flat_t) != manifest["num_leaves"]:
        raise ValueError(f"leaf count mismatch: ckpt "
                         f"{manifest['num_leaves']} vs template "
                         f"{len(flat_t)}")
    saved_fp = manifest.get("treedef")
    if saved_fp is not None and saved_fp != tree_fingerprint(template):
        raise ValueError(
            f"checkpoint tree structure mismatch at {path}: saved "
            f"fingerprint {saved_fp} != template "
            f"{tree_fingerprint(template)}: the template's container "
            "structure (keys/layout) differs from what was saved")
    digests = manifest.get("sha256")
    restored = []
    for i, t in enumerate(flat_t):
        name = f"leaf_{i:05d}"
        try:
            arr = data[name]
        except Exception as e:  # truncated/torn npz member
            raise CheckpointCorruptionError(
                f"cannot read {name} from {path}/arrays.npz: {e}",
                leaf_index=i, leaf_name=name) from e
        if digests is not None:
            live = _payload_sha256(arr)
            if live != digests[i]:
                raise CheckpointCorruptionError(
                    f"payload sha256 mismatch for {name} at {path}: "
                    f"stored {digests[i][:12]}..., read {live[:12]}...",
                    leaf_index=i, leaf_name=name)
        if list(arr.shape) != list(t.shape):
            raise ValueError(f"shape mismatch at leaf {i}: {arr.shape} vs "
                             f"{tuple(t.shape)}")
        restored.append(_to_tensor(arr, manifest["dtypes"][i], t))
    return unflatten_like(template, restored), step, manifest["extras"]


def cleanup_old(directory: str, keep: int = 3) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d))
