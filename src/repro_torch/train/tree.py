"""Nested dicts of tensors as the reference's pytrees: leaves in the
order ``jax.tree.leaves`` gives them (keys sorted at every level), with
``/``-joined key paths."""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple


def items(tree: dict, prefix: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) pairs in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(items(v, path + "/"))
        else:
            out.append((path, v))
    return out


def leaves(tree: dict) -> list:
    return [leaf for _, leaf in items(tree)]


def unflatten(flat: Dict[str, object]) -> dict:
    """The nested dict of ``/``-joined paths."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def map_tree(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    return {k: map_tree(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
