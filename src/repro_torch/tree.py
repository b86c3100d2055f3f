"""Nested trees of tensors, walked as the reference's ``jax.tree_util``
walks its pytrees.

A tree is nested dicts, lists, tuples and NamedTuples; anything else is
a leaf. Dict keys are visited sorted, sequences and NamedTuple fields in
order, so :func:`leaves` gives ``jax.tree.leaves``' order. A leaf's path
key is the reference's ``"/".join(str(k) for k in path)``: ``['k']`` for
a dict key, ``[i]`` for a sequence position and ``.name`` for a
NamedTuple field (``jax.tree_util.GetAttrKey``), so that
``TrainState(params={"w": w}, ...)`` keys ``w`` as ``.params/['w']``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

Tree = Any


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_with_paths(tree: Tree, prefix: str = "", *,
                       is_leaf: Optional[Callable[[Any], bool]] = None
                       ) -> List[Tuple[str, Any]]:
    """(path key, leaf) pairs in the reference's order and spelling; a
    node for which ``is_leaf`` holds is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix[1:], tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_paths(tree[k], f"{prefix}/[{k!r}]",
                                      is_leaf=is_leaf)
        return out
    if _is_namedtuple(tree):
        out = []
        for name, v in zip(tree._fields, tree):
            out += flatten_with_paths(v, f"{prefix}/.{name}",
                                      is_leaf=is_leaf)
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_paths(v, f"{prefix}/[{i}]", is_leaf=is_leaf)
        return out
    return [(prefix[1:], tree)]


def flatten_with_keys(tree: Tree, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(keys, leaf) pairs in the reference's order, each path spelled as
    its ``[str(getattr(p, "key", p)) for p in path]``: the bare dict key,
    ``[i]`` for a sequence position, ``.name`` for a NamedTuple field."""
    if isinstance(tree, dict):
        return [kl for k in sorted(tree)
                for kl in flatten_with_keys(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kl for name, v in zip(tree._fields, tree)
                for kl in flatten_with_keys(v, prefix + (f".{name}",))]
    if isinstance(tree, (list, tuple)):
        return [kl for i, v in enumerate(tree)
                for kl in flatten_with_keys(v, prefix + (f"[{i}]",))]
    return [(prefix, tree)]


def unflatten(template: Tree, values: Dict[str, Any], prefix: str = ""
              ) -> Tree:
    """``template``'s structure with each leaf replaced by ``values`` at
    its path key."""
    if isinstance(template, dict):
        return {k: unflatten(template[k], values, f"{prefix}/[{k!r}]")
                for k in sorted(template)}
    if _is_namedtuple(template):
        return type(template)(*(
            unflatten(v, values, f"{prefix}/.{name}")
            for name, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten(v, values, f"{prefix}/[{i}]")
                              for i, v in enumerate(template))
    return values[prefix[1:]]


def leaves(tree: Tree) -> List[Any]:
    """The leaves in ``jax.tree.leaves``' order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure), in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)
