"""Checkpoint save / restore as torch files under the JAX package's names
(`training/checkpointing.py` there writes Orbax directories).

The layout is the reference's (strategies/ddp.py:26-53):
<dir>/step-{step:06d}-epoch-{epoch:02d}[-loss={loss:.4f}]/ holding one
`checkpoint.pt`, and a `latest-checkpoint` symlink to the newest one,
replaced on every save. A payload is a tree of dicts, lists and tuples
over tensors, numpy arrays and Python scalars; `restore_checkpoint` gives
tensors back on the CPU and numpy arrays as numpy arrays.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

FILE = "checkpoint.pt"
LATEST = "latest-checkpoint"
_NUMPY = "__numpy__"  # tag of a numpy leaf stored as a tensor


def _to_file(tree):
    if isinstance(tree, dict):
        return {k: _to_file(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_file(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.ndarray) or isinstance(tree, np.generic):
        return {_NUMPY: torch.from_numpy(np.array(tree))}
    return tree


def _from_file(tree):
    if isinstance(tree, dict):
        if set(tree) == {_NUMPY}:
            return tree[_NUMPY].numpy()
        return {k: _from_file(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_file(v) for v in tree)
    return tree


def save_checkpoint(
    directory: str,
    step: int,
    params: Dict,
    opt_state: Any = None,
    epoch: int = 0,
    loss: Optional[float] = None,
    keep_latest_copy: bool = True,
) -> str:
    """Write <dir>/step-{step:06d}-epoch-{epoch:02d}[-loss={loss:.4f}] and
    point <dir>/latest-checkpoint at it. Returns the checkpoint's path."""
    name = f"step-{step:06d}-epoch-{epoch:02d}"
    if loss is not None:
        name += f"-loss={loss:.4f}"
    path = os.path.abspath(os.path.join(directory, name))
    os.makedirs(path, exist_ok=True)
    payload = {"params": params}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    tmp = os.path.join(path, FILE + ".part")
    torch.save(_to_file(payload), tmp)
    os.replace(tmp, os.path.join(path, FILE))
    if keep_latest_copy:
        latest = os.path.abspath(os.path.join(directory, LATEST))
        if os.path.islink(latest):
            os.unlink(latest)
        elif os.path.exists(latest):
            shutil.rmtree(latest)
        os.symlink(path, latest)
    return path


def restore_checkpoint(path: str) -> Dict:
    """{"params", "opt_state" (when saved)} of the checkpoint at `path` (a
    `latest-checkpoint` link is resolved), tensors on the CPU. The payload
    carries its own structure (JAX's Orbax restore takes a template)."""
    path = os.path.realpath(os.path.abspath(path))
    payload = torch.load(os.path.join(path, FILE), map_location="cpu", weights_only=True)
    return _from_file(payload)


def latest_checkpoint(directory: str) -> Optional[str]:
    latest = os.path.join(directory, LATEST)
    return os.path.realpath(latest) if os.path.exists(latest) else None
