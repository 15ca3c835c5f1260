"""Tensor-parallel splits of the VLA parameter tree (the JAX package's
`parallel/sharding.py`).

JAX annotates each leaf with a PartitionSpec and GSPMD places the shards and
inserts the collectives. Here each rank is a process: the same tables say
which dim of a leaf splits over the 'model' axis, and `shard_decode_params`
/ `shard_params` (leaf by leaf: `shard_leaves`) cut this rank's slice of
every leaf. The decode and the attack's forward then call their
collectives themselves (models/decode.py; parallel/tensor_parallel.py).

Storage layout (Llama block), `llama_param_specs`:
  q/k/v:   [L, D, H*hd]   split on heads (last dim)   - column parallel
  o:       [L, H*hd, D]   split on heads (dim 1)      - row parallel (sum after)
  gate/up: [L, D, I]      split on I                  - column parallel
  down:    [L, I, D]      split on I (dim 1)          - row parallel
  embed:   [V, D]         split on V
  lm_head: [D, V]         split on V
ViTs and the projector stay replicated (with `shard_projector`: fc1
column-, fc2 row-parallel, fc3 replicated).

The cooked decode layout (`decode_param_specs`) is the serving flavour, see
its docstring. `shard_decode_leaves` builds a rank's cooked, quantized and
cut tree from leaves that arrive one at a time, so no rank holds more than
one full stacked leaf of the model on its device while it loads.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from ..models.param_tree import tree_from_leaves, tree_leaves


class PartitionSpec(tuple):
    """The counterpart of jax.sharding.PartitionSpec: one entry per dim of a
    leaf, the mesh axis name it splits over or None; an empty spec (or a
    shorter one) leaves the remaining dims whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def llama_param_specs(model_axis: str = "model") -> Dict:
    m = model_axis
    return {
        "embed": P(m, None),
        "layers": {
            "attn_norm": P(),
            "q_w": P(None, None, m),
            "k_w": P(None, None, m),
            "v_w": P(None, None, m),
            "o_w": P(None, m, None),
            "mlp_norm": P(),
            "gate_w": P(None, None, m),
            "up_w": P(None, None, m),
            "down_w": P(None, m, None),
        },
        "norm": P(),
        "lm_head": P(None, m),
    }


def phi_param_specs(model_axis: str = "model") -> Dict:
    """The Phi-2 block (models/phi.py layout): q/k/v and fc1 column-split
    with their biases, o/fc2 row-split (sum after), norms and the biases
    added after the sum replicated."""
    m = model_axis
    return {
        "ln_scale": P(), "ln_bias": P(),
        "q_w": P(None, None, m), "q_b": P(None, m),
        "k_w": P(None, None, m), "k_b": P(None, m),
        "v_w": P(None, None, m), "v_b": P(None, m),
        "o_w": P(None, m, None), "o_b": P(),
        "fc1_w": P(None, None, m), "fc1_b": P(None, m),
        "fc2_w": P(None, m, None), "fc2_b": P(),
    }


def _decoder_layer_specs(layer_keys: set, model_axis: str) -> Dict:
    """Spec dict for a stacked decoder-layer tree; a key with no spec
    raises KeyError rather than silently staying replicated."""
    llama = llama_param_specs(model_axis)["layers"]
    if layer_keys <= set(llama):
        return {k: llama[k] for k in layer_keys}
    phi = phi_param_specs(model_axis)
    if layer_keys <= set(phi):
        return {k: phi[k] for k in layer_keys}
    unknown = layer_keys - set(llama) - set(phi)
    raise KeyError(
        f"decoder layer keys {sorted(unknown)} have no TP PartitionSpec; "
        f"add them to llama_param_specs/phi_param_specs"
    )


def vla_param_specs(params: Dict, model_axis: str = "model", shard_projector: bool = False) -> Dict:
    """The spec tree matching `params`' structure (storage layout), leaf by
    leaf (`vla_leaf_spec`)."""
    return tree_from_leaves((path, vla_leaf_spec(path, x, model_axis, shard_projector))
                            for path, x in tree_leaves(params))


def vla_leaf_spec(path: Tuple[str, ...], x: torch.Tensor, model_axis: str = "model",
                  shard_projector: bool = False) -> P:
    """The spec of one leaf of the storage-layout tree by its path (and, for
    a Phi lm_head, its rank), without the whole tree: vision replicated; the
    projector replicated, or with `shard_projector` fc1 column- and fc2
    row-split (fc3 and fc2's bias replicated); embed and lm_head split on
    the vocab; the decoder layers by llama_param_specs / phi_param_specs
    (KeyError on a key neither has); norms replicated."""
    m = model_axis
    if path[0] == "projector" and shard_projector:
        return {"fc1_w": P(None, m), "fc1_b": P(m), "fc2_w": P(m, None)}.get(path[1], P())
    if path[0] != "llm":
        return P()
    if path[1] == "embed":
        return P(m, None)
    if path[1] == "layers":
        return _decoder_layer_specs({path[2]}, m)[path[2]]
    if path[1] == "lm_head":
        return P(None, m) if x.dim() == 2 else P(m)
    return P()


def split_dim(spec: Tuple, model_axis: str = "model") -> Optional[int]:
    """The dim of a leaf that `spec` splits over the model axis, or None."""
    return spec.index(model_axis) if model_axis in spec else None


def take_shard(x: torch.Tensor, dim: Optional[int], index: int, parts: int) -> torch.Tensor:
    """Slice `index` of `parts` equal slices of `x` along `dim` (x itself
    for dim None or one part); raises if the dim does not split evenly."""
    if dim is None or parts == 1:
        return x
    size = x.shape[dim]
    if size % parts:
        raise ValueError(f"a dim of {size} does not split evenly over {parts} model ranks")
    n = size // parts
    return x.narrow(dim, index * n, n)


def shard_leaves(leaves: Iterable[Tuple[Tuple[str, ...], torch.Tensor]], mesh, model_axis: str = "model",
                 shard_projector: bool = False):
    """(path, this rank's slice on its device) of each storage-layout leaf
    as it arrives: each leaf is cut and moved, and dropped before the next
    is drawn or read, so a rank holds what it keeps and one whole leaf at
    most (the attack's load of the 7B, PR 12's lesson for serving)."""
    for path, x in leaves:
        dim = split_dim(vla_leaf_spec(path, x, model_axis, shard_projector), model_axis)
        out = take_shard(x, dim, mesh.m, mesh.tp).to(mesh.device)
        # a cut leaf is copied out: a view would keep the whole leaf alive
        out = out.clone(memory_format=torch.contiguous_format) if dim is not None and mesh.tp > 1 \
            else out.contiguous()
        del x  # the whole leaf goes before the next one is drawn or read
        yield path, out


def shard_params(params: Dict, mesh, model_axis: str = "model", shard_projector: bool = False) -> Dict:
    """This rank's slice of every leaf of a storage-layout tree, on its
    device (`vla_param_specs` split over mesh.tp ranks, slice mesh.m)."""
    return tree_from_leaves(shard_leaves(tree_leaves(params), mesh, model_axis, shard_projector))


# ------------------------------------------------------------- decode (serving)

COLUMN_PARALLEL = ("q_w", "k_w", "v_w", "gate_w", "up_w")
ROW_PARALLEL = ("o_w", "down_w")


def _cooked_layer_spec(key: str, ndim: int, m: str = "model") -> P:
    """The spec of one leaf of the cooked decode tree's layers, by its key
    and rank. A quantization scale follows its stack: int8 [L, out] splits
    out on a column-parallel stack and replicates on a row-parallel one
    (scaling the partial products before the sum is exact); int4 grouped
    [L, out, G] splits out, or the groups on a row-parallel stack."""
    if key in ("attn_norm", "mlp_norm"):
        return P()
    if key in COLUMN_PARALLEL:
        return P(None, m, None)
    if key in ROW_PARALLEL:
        return P(None, None, m)
    base = key[: -len("_scale")] if key.endswith("_scale") else None
    grouped = ndim == 3
    if base in COLUMN_PARALLEL:
        return P(None, m, None) if grouped else P(None, m)
    if base in ROW_PARALLEL:
        return P(None, None, m) if grouped else P()
    raise KeyError(
        f"decode TP supports the Llama-family layer layout only; unknown key {key!r}"
    )


def _cooked_llm_spec(key: str, ndim: int, m: str = "model") -> P:
    """The spec of a leaf of the cooked decode tree's llm outside the
    layers."""
    if key == "lm_head":
        return P(None, m)
    if key == "lm_head_scale":  # int8 [V] / int4 [V, G]: follows the vocab split
        return P(m, None) if ndim == 2 else P(m)
    return P()  # embed, embed_scale, norm: replicated


def _decode_spec(path: Tuple[str, ...], ndim: int, m: str = "model") -> P:
    if path[:2] == ("llm", "layers"):
        return _cooked_layer_spec(path[2], ndim, m)
    if path[0] == "llm":
        return _cooked_llm_spec(path[1], ndim, m)
    return P()  # vision, projector: replicated


def decode_param_specs(params: Dict, model_axis: str = "model") -> Dict:
    """TP specs for the COOKED decode tree (models/decode.py
    decode_layout_params output: projection stacks are [L, out, in]).

    Megatron split, serving flavour:
      q/k/v cooked [L, H*hd, D]  split on heads (dim 1)  - column parallel
      o     cooked [L, D, H*hd]  split on heads (dim 2)  - row parallel (sum)
      gate/up [L, I, D]          split on I (dim 1)      - column parallel
      down    [L, D, I]          split on I (dim 2)      - row parallel (sum)
      lm_head [D, V]             split on V: each step gathers one [B, s, V]
                                 f32 logit row for the argmax
      embed                      replicated: the decode reads one row a
                                 token, a vocab-split embed would cost a
                                 collective per token
      vision/projector/norms     replicated
    The quantization scales follow their stacks (_cooked_layer_spec).
    Raises KeyError on non-Llama layer keys."""
    return tree_from_leaves((path, _decode_spec(path, x.dim(), model_axis)) for path, x in tree_leaves(params))


def shard_decode_params(params: Dict, mesh) -> Dict:
    """This rank's slice of every leaf of a COOKED (maybe quantized) decode
    tree, on its device."""
    return shard_decode_leaves(((p, x.to(mesh.device)) for p, x in tree_leaves(params)), mesh, cooked=True)


# ------------------------------------------------------ the streaming load


def shard_decode_leaves(leaves: Iterable[Tuple[Tuple[str, ...], torch.Tensor]], mesh, cooked: bool = False,
                        quant: Optional[str] = None, group_size: Optional[int] = None) -> Dict:
    """This rank's cooked (and, with `quant`, quantized) decode tree from
    the leaves of a whole tree that arrive one at a time: the cut, by
    decode_param_specs, of quantize_decode_params(decode_layout_params(tree)).

    The leaves come on the rank's device. A float projection stack is
    cooked, quantized and cut one layer at a time into the rank's stack,
    and dropped before the next leaf is drawn or read: when the producer
    keeps none either, no more than one full stacked leaf of the model is on
    the device at once. A mesh of one rank keeps every leaf whole. Quantization
    runs on the whole layer before the cut (an int8 scale of a row-parallel
    stack spans the whole contraction). `cooked` says the stacks are
    already [L, out, in]; a leaf that is already int8 is cut as it is."""
    return tree_from_leaves(_shard_leaves(leaves, mesh, cooked, quant, group_size))


def _cut(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of `x` by `spec` (a PartitionSpec, or a callable
    giving it: a model of one rank keeps every leaf whole and asks for no
    spec, so any layer layout loads)."""
    if mesh.tp == 1:
        return x.contiguous()
    spec = spec() if callable(spec) else spec
    return take_shard(x, split_dim(spec), mesh.m, mesh.tp).contiguous()


def _shard_leaves(leaves, mesh, cooked: bool, quant: Optional[str], group_size: Optional[int]):
    for path, x in leaves:
        out = _shard_leaf(path, x, mesh, cooked, quant, group_size)
        del x  # the whole leaf goes before the next one is drawn or read
        yield from out


def _shard_leaf(path, x, mesh, cooked: bool, quant: Optional[str], group_size: Optional[int]) -> list:
    """[(path, this rank's leaf)] of one leaf of the whole tree: a float
    projection stack cooked, quantized (with its scale) and cut one layer
    at a time; lm_head and embed quantized whole; any other leaf cut."""
    from ..models.decode import _COOKED_KEYS
    from ..models.quant import quantize_matrix

    if path[:2] == ("llm", "layers") and path[2] in _COOKED_KEYS and x.is_floating_point():
        key = path[2]
        n = x.shape[0]
        # one layer's [out, in] matrix: the stack's spec without its L dim
        w_spec = P(*_cooked_layer_spec(key, 3)[1:])
        s_spec = P(*_cooked_layer_spec(key + "_scale", 3 if quant == "int4" else 2)[1:])
        w_local = s_local = None
        for i in range(n):
            w, s = x[i] if cooked else x[i].T, None
            if quant is not None:
                w, s = quantize_matrix(w, quant, group_size, key)
            w = _cut(w, w_spec, mesh)
            if w_local is None:
                w_local = torch.empty((n, *w.shape), dtype=w.dtype, device=w.device)
            w_local[i].copy_(w)
            if s is not None:
                s = _cut(s, s_spec, mesh)
                if s_local is None:
                    s_local = torch.empty((n, *s.shape), dtype=s.dtype, device=s.device)
                s_local[i].copy_(s)
        out = [(path, w_local)]
        if s_local is not None:
            out.append((path[:-1] + (key + "_scale",), s_local))
        return out
    if path == ("llm", "lm_head") and quant is not None and x.is_floating_point():
        # [D, V]: the contraction is dim 0 -> quantize the [V, D] transpose
        q, s = quantize_matrix(x.transpose(0, 1), quant, group_size, "lm_head")
        return [(path, _cut(q.transpose(0, 1), _cooked_llm_spec("lm_head", 2), mesh)),
                (("llm", "lm_head_scale"), _cut(s, _cooked_llm_spec("lm_head_scale", s.dim()), mesh))]
    if path == ("llm", "embed") and quant is not None and x.is_floating_point():
        q, s = quantize_matrix(x, "int8", 0, "embed")
        return [(path, q), (("llm", "embed_scale"), s)]
    return [(path, _cut(x, lambda: _decode_spec(path, x.dim()), mesh))]
