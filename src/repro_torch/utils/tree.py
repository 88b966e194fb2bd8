"""Key paths, maps and leaves over nested containers; the key paths are
spelled as ``repro.utils.tree``'s.

``repro`` flattens pytrees with JAX; the port keeps its own walk over
dicts, lists and tuples, so a checkpoint's flat keys (``a/0/b``) and their
order are the same in both packages: dict keys sorted, list and tuple
entries by index, a named tuple's fields as ``.name`` (JAX's attribute
key, e.g. ``AdamWState``'s ``1/.mu/...``), ``None`` an empty subtree,
anything else a leaf.
"""
from __future__ import annotations


def flat_paths(tree) -> dict:
    """Flatten ``tree`` into {'a/b/c': leaf}, in JAX's leaf order."""
    out: dict = {}
    _walk(tree, (), out)
    return out


def _walk(node, path, out) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for key in sorted(node):
            _walk(node[key], path + (str(key),), out)
    elif _is_namedtuple(node):
        for name, sub in zip(node._fields, node):
            _walk(sub, path + (f".{name}",), out)
    elif isinstance(node, (list, tuple)):
        for i, sub in enumerate(node):
            _walk(sub, path + (str(i),), out)
    else:
        out["/".join(path)] = node


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), keeping dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, t, *(r[i] for r in rest))
                 for i, t in enumerate(tree)]
        return type(tree)(*items) if _is_namedtuple(tree) else type(tree)(
            items)
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path=()):
    """``fn(key, leaf)`` over the leaves of ``tree``, ``key`` the leaf's
    ``flat_paths`` key; keeps dicts, lists and tuples."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f".{n}",))
                            for n, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``flat_paths``' order."""
    return list(flat_paths(tree).values())
