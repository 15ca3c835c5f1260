"""`ParamTree`: an nn.Module that holds a nested dict of tensors under the JAX
pytree's key names.

A leaf `layers.q_w` of the JAX pytree becomes the tensor named
`layers.q_w` in `named_parameters()` / `named_buffers()`, so one dotted path
names a weight in both packages. Stacked `[L, ...]` layer weights stay
stacked. Float weights are frozen parameters; integer (quantized) stacks and
their `*_scale` leaves are buffers. `tree()` returns the nested dict back,
which is what the functional model code (vit_features,
greedy_decode_actions, ...) takes.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Mapping, Optional, Tuple

import torch
from torch import nn


def _is_buffer(tree: Mapping, name: str) -> bool:
    """Integer tensors, and the f32 scale `k + "_scale"` of an integer `k`."""
    t = tree[name]
    if not t.is_floating_point():
        return True
    base = tree.get(name[: -len("_scale")]) if name.endswith("_scale") else None
    return isinstance(base, torch.Tensor) and not base.is_floating_point()


class ParamTree(nn.Module):
    def __init__(self, tree: Optional[Mapping] = None) -> None:
        super().__init__()
        for k, v in (tree or {}).items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            elif _is_buffer(tree, k):
                self.register_buffer(k, v)
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> Dict:
        out: Dict = {k: m.tree() for k, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        out.update(self.named_buffers(recurse=False))
        return out


def tree_leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """(path, leaf) of every leaf of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from tree_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_from_leaves(leaves: Iterable[Tuple[Tuple[str, ...], object]]) -> Dict:
    """The nested dict of (path, leaf) pairs (tree_leaves' inverse)."""
    out: Dict = {}
    for path, leaf in leaves:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
