"""Parameter and optimizer-state trees: nested dicts, lists, tuples and
NamedTuples with tensor leaves, walked in ``jax.tree_util``'s order (dict
keys sorted, sequences and NamedTuple fields in order), so a flat list
of leaves lines up with the reference's ``tree_leaves``.

A path is a tuple of entries ``("k", key)`` (a dict key or a NamedTuple
field) and ``("i", index)`` (a list or tuple element).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Tuple

Path = Tuple[Tuple[str, Any], ...]


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def flatten_with_path(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """Every leaf with its path, in the reference's order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in flatten_with_path(tree[k], path + (("k", k),))]
    if _is_namedtuple(tree):
        return [pl for f in tree._fields
                for pl in flatten_with_path(getattr(tree, f),
                                            path + (("k", f),))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in flatten_with_path(v, path + (("i", i),))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves: Iterable):
    """A tree shaped as ``like`` with ``new_leaves`` (in
    :func:`flatten_with_path`'s order) in place of its leaves."""
    it = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


_END = object()


def _rebuild(like, it):
    if isinstance(like, dict):
        vals = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: vals[k] for k in like}          # the caller's key order
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), it)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the tree holds")
    return leaf


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, in its structure."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])


def path_key(path: Path) -> str:
    """The checkpoint key of a path: the reference's ``k:<key>`` /
    ``i:<index>`` entries joined by ``|``
    (``repro/checkpoint/manager.py:_flatten``)."""
    return "|".join(f"{kind}:{v}" for kind, v in path)


def path_str(path: Path) -> str:
    """A path as ``jax.tree_util``'s keys print it (``['layers']/[0]``),
    for the reference's rules that match substrings of it."""
    return "/".join(f"['{v}']" if kind == "k" else f"[{v}]"
                    for kind, v in path)
