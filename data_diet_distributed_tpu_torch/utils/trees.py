"""Size helpers over the port's variables (counterpart of
``data_diet_distributed_tpu/utils/trees.py``): a flat state dict of tensors,
or any nesting of mappings, lists and tuples of tensors or numpy arrays."""

from __future__ import annotations

from collections.abc import Iterator, Mapping


def _leaves(tree) -> Iterator:
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def param_count(tree) -> int:
    """Elements over every leaf."""
    return sum(int(leaf.numel()) if hasattr(leaf, "numel") else int(leaf.size)
               for leaf in _leaves(tree))


def tree_bytes(tree) -> int:
    """Bytes over every leaf, at each leaf's own dtype."""
    return sum(int(leaf.nbytes) for leaf in _leaves(tree))
