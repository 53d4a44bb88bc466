"""Pytrees the way the JAX package flattens them.

Wire metas, shard assignments and checkpoint manifests all key on the
``/``-joined path of each leaf, so the port must walk a tree in exactly
JAX's leaf order and name each step exactly as
``repro.checkpoint.store.path_key`` does:

* a ``dict`` is walked in sorted key order (``torch.utils._pytree`` keeps
  insertion order, which is why it is not used here), a step is the key;
* a ``NamedTuple`` is walked in field order, a step is the field name;
* a ``list`` or plain ``tuple`` is walked in order, a step is ``#i``;
* ``None`` is an empty subtree; everything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

PyTree = Any
SEP = "/"


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node: Any) -> list[tuple[str, Any]] | None:
    """``(step name, child)`` pairs of an inner node; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"#{i}", c) for i, c in enumerate(node)]
    return None


def _walk(node: Any, path: tuple[str, ...]) -> Iterator[tuple[tuple[str, ...], Any]]:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        yield path, node
        return
    for name, child in kids:
        yield from _walk(child, path + (name,))


def flatten_with_path(tree: PyTree) -> list[tuple[tuple[str, ...], Any]]:
    """``(path, leaf)`` for every leaf, in JAX's leaf order."""
    return list(_walk(tree, ()))


def leaves(tree: PyTree) -> list[Any]:
    return [leaf for _, leaf in _walk(tree, ())]


def path_key(path: tuple[str, ...]) -> str:
    return SEP.join(path)


def tree_keys(tree: PyTree) -> list[str]:
    """The ``/``-joined key of every leaf, in leaf order."""
    return [path_key(p) for p, _ in _walk(tree, ())]


def unflatten(like: PyTree, new_leaves: list[Any]) -> PyTree:
    """A tree shaped like ``like`` holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)

    def build(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: None for k in node}  # keep the caller's key order
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn: Callable[..., Any], tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` applied leafwise over trees of one structure."""
    flat = leaves(tree)
    others = [leaves(r) for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(flat, *others)])
