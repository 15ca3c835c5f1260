"""Attack artifacts: patch checkpoints, adversarial PNG dumps, metric pickles
(the JAX package's `attacks/artifacts.py`, the same files and layout).

`patch.pt` is a torch-saved float32 [3, H, W] CPU tensor in [0, 1], so a
patch is interchangeable with the JAX package's `load_patch` and the
reference's eval. PNGs are written by a small zlib encoder (8-bit RGB), so
saving needs no imaging library; frames are quantized by truncation, like
torchvision's ToPILImage.
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch


def save_patch_pt(patch_hwc: np.ndarray, path: str) -> None:
    """Save an [H, W, 3] float patch as the reference's [3, H, W] tensor."""
    chw = np.transpose(np.asarray(patch_hwc, np.float32), (2, 0, 1)).copy()
    torch.save(torch.from_numpy(chw), path)


def load_patch(path: str) -> np.ndarray:
    """A patch from .pt ([3, H, W]) or .npy -> [H, W, 3] float32 in [0, 1]."""
    if path.endswith(".npy"):
        arr = np.load(path)
    else:
        arr = torch.load(path, map_location="cpu", weights_only=True).float().numpy()
    if arr.ndim == 3 and arr.shape[0] == 3 and arr.shape[-1] != 3:
        arr = np.transpose(arr, (1, 2, 0))
    return np.clip(arr.astype(np.float32), 0.0, 1.0)


def write_png(rgb_u8: np.ndarray, path: str) -> None:
    """[H, W, 3] uint8 -> an 8-bit RGB PNG (no filtering)."""
    rgb = np.ascontiguousarray(rgb_u8, dtype=np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def save_patch_png(patch_hwc: np.ndarray, path: str) -> None:
    """An [H, W, 3] patch in [0, 1] as an 8-bit RGB PNG (truncated)."""
    write_png(_to_u8(patch_hwc), path)


def save_adv_images(images_hwc: np.ndarray, directory: str) -> List[str]:
    """Dump patched frames (raw [B, H, W, 3] in [0, 1]) as <i>.png."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, img in enumerate(np.asarray(images_hwc)):
        p = os.path.join(directory, f"{i}.png")
        write_png(_to_u8(img), p)
        paths.append(p)
    return paths


def save_checkpoint(
    save_dir: str,
    tag: str,
    patch_hwc: np.ndarray,
    adv_images: Optional[np.ndarray] = None,
    extras: Optional[Dict[str, np.ndarray]] = None,
) -> str:
    """Write <save_dir>/<tag>/patch.pt (+ patch.png, patch.npy,
    val_related_data/)."""
    d = os.path.join(save_dir, tag)
    os.makedirs(d, exist_ok=True)
    save_patch_pt(patch_hwc, os.path.join(d, "patch.pt"))
    save_patch_png(patch_hwc, os.path.join(d, "patch.png"))
    np.save(os.path.join(d, "patch.npy"), np.asarray(patch_hwc, np.float32))
    if adv_images is not None or extras:
        vd = os.path.join(d, "val_related_data")
        os.makedirs(vd, exist_ok=True)
        if adv_images is not None:
            save_adv_images(adv_images, vd)
        for name, arr in (extras or {}).items():
            np.save(os.path.join(vd, f"{name}.npy"), np.asarray(arr))
    return d


def save_history_pickles(save_dir: str, histories: Dict[str, list]) -> None:
    os.makedirs(save_dir, exist_ok=True)
    for name, values in histories.items():
        with open(os.path.join(save_dir, f"{name}.pkl"), "wb") as f:
            pickle.dump(values, f)


def plot_loss_curve(loss_values: list, save_dir: str) -> Optional[str]:
    """loss_curve.png; skipped where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    os.makedirs(save_dir, exist_ok=True)
    plt.plot(range(len(loss_values)), loss_values, label="Target Loss")
    plt.title("Loss Plot")
    plt.xlabel("Iters")
    plt.ylabel("Loss")
    plt.legend(loc="best")
    out = os.path.join(save_dir, "loss_curve.png")
    plt.savefig(out)
    plt.clf()
    return out
