"""Parameter and state trees: nested dicts and lists of tensors, the role
`jax.tree` plays in the reference. Dict keys are visited in sorted order,
as jax flattens them, so leaves line up with the reference's."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def walk(tree: Any, path: Tuple[str, ...] = ()
         ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) for every leaf; a path holds dict keys and list
    indices as strings."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (str(i),))
    else:
        yield path, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in walk(tree)]


def tree_map(fn: Callable, tree: Any) -> Any:
    """`fn` on every leaf, visited in `leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
