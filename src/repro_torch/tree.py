"""Pytree helpers for the port's nested state (dicts, NamedTuples,
lists and tuples of tensors), in the order ``jax.tree`` flattens the
same structure: dict keys sorted, NamedTuple fields in order, sequence
items in order; ``None`` is an empty subtree.

Each leaf's path is rendered as the JAX package's checkpoint renders key
paths (``repro/checkpoint/ckpt.py`` ``_key_str``): ``d:'name'`` for a dict
key, ``a:'field'`` for a NamedTuple field, ``s:0`` for a sequence index.
So a structure flattens to the same leaves, in the same order and under
the same paths, in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

Path = Tuple[str, ...]


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree: Any, path: Path = ()) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in flatten_with_path(tree[key],
                                              path + (f"d:{key!r}",))]
    if _is_namedtuple(tree):
        return [item for name in tree._fields
                for item in flatten_with_path(getattr(tree, name),
                                              path + (f"a:{name!r}",))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten_with_path(v, path + (f"s:{i!r}",))]
    return [(path, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten_like(template: Any, flat: Sequence[Any]) -> Any:
    """``template``'s structure with its leaves replaced, in order, by
    ``flat``."""
    it = iter(flat)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {key: build(t[key]) for key in sorted(t)}
            return {key: out[key] for key in t}
        if _is_namedtuple(t):
            return type(t)(*[build(getattr(t, n)) for n in t._fields])
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten_like(tree, [fn(*xs) for xs in zip(*flat)])
