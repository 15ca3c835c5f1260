"""Evaluation-time image/prompt processing.

  - PrismaticImageProcessor parity: PIL bicubic resize to 224 (PIL is
    imported only when a frame needs resizing; model-sized frames never do);
  - the eval prompt string.
"""

from __future__ import annotations

import numpy as np

from .. import not_ported
from ..utils.constants import IMAGE_SIZE


def resize_bicubic_pil(image: np.ndarray, size: int = IMAGE_SIZE) -> np.ndarray:
    """uint8 HWC -> uint8 [size, size, 3] via PIL bicubic."""
    from PIL import Image

    pil = Image.fromarray(np.asarray(image, np.uint8)).convert("RGB")
    pil = pil.resize((size, size), Image.BICUBIC)
    return np.asarray(pil, np.uint8)


def center_crop_resize_tf(image: np.ndarray, crop_scale: float = 0.9) -> np.ndarray:
    """The optional eval-time center crop; the JAX package computes it with
    TensorFlow's crop_and_resize, which the port does not depend on."""
    raise not_ported("center_crop_resize_tf", "slice 5: center crop")


def eval_prompt(task_label: str) -> str:
    return f"In: What action should the robot take to {task_label.lower()}?\nOut:"
