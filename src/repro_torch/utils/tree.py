"""Key paths, maps and leaves over nested containers; the key paths are
spelled as ``repro.utils.tree``'s.

``repro`` flattens pytrees with JAX; the port keeps its own walk over
dicts, lists and tuples, so a checkpoint's flat keys (``a/0/b``) and their
order are the same in both packages: dict keys sorted, list and tuple
entries by index, ``None`` an empty subtree, anything else a leaf.
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
    elif isinstance(node, (list, tuple)):
        for i, sub in enumerate(node):
            _walk(sub, path + (str(i),), out)
    else:
        out["/".join(path)] = node


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), keeping dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``flat_paths``' order."""
    return list(flat_paths(tree).values())
