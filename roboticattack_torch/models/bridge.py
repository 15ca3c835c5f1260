"""Weight bridge: a JAX parameter pytree (nested dicts of numpy arrays) ->
the port's modules.

Works for the float pytree (init_vla_params / a converted checkpoint) and
for the cooked, quantized one (decode_layout_params + quantize_decode_params):
every leaf keeps its name, shape and dtype. bf16 leaves arrive as
`ml_dtypes.bfloat16` numpy arrays, which `torch.from_numpy` rejects; they
are reinterpreted through a uint16 view, bit for bit.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .config import VLAConfig
from .vlm import VLA


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One numpy (or array-like) leaf -> a torch tensor on `device`,
    bit-identical, bf16 included."""
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def params_from_jax(tree: Mapping, device="cpu", cfg: Optional[VLAConfig] = None):
    """A JAX pytree (nested dict of numpy arrays) -> the port's state: the
    same nested dict of tensors on `device`. With `cfg` (a full VLA pytree,
    keys vision/projector/llm) -> the `VLA` module, its tensors named by the
    pytree paths (`llm.layers.q_w`, ...)."""
    state = {
        k: params_from_jax(v, device) if isinstance(v, Mapping) else tensor_from_numpy(v, device)
        for k, v in tree.items()
    }
    return state if cfg is None else VLA(cfg, state)
