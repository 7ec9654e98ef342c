"""Flatten and rebuild nested containers in the JAX package's leaf order.

The port keeps solver states as NamedTuples of tensors, nested in dicts, as
the JAX package keeps them as pytrees. Checkpoints store a state as its
flat leaves and the debug helpers name a leaf by its path, so both need
``jax.tree_util``'s order and path format without importing it:

* a dict's values in sorted key order, a path step written ``['key']``;
* a NamedTuple's fields in declaration order, written ``.field``;
* a list's or tuple's items in order, written ``[i]``;
* None is an empty subtree (no leaf); anything else is a leaf.
"""

from typing import Any, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` with paths as ``jax.tree_util.keystr``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], f"{prefix}[{k!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += flatten_with_path(getattr(tree, name), f"{prefix}.{name}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_path(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in flatten order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like: Any, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in flatten order, by
    ``new_leaves``."""
    it = iter(new_leaves)
    end = object()

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, name)) for name in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        leaf = next(it, end)
        if leaf is end:
            raise ValueError("fewer leaves than the reference tree holds")
        return leaf

    out = build(like)
    if next(it, end) is not end:
        raise ValueError("more leaves than the reference tree holds")
    return out
