"""Policy wrapper (VLAPolicy, load_policy), eval-time processing, and the
closed-loop evaluation drivers (LIBERO, the eval queue, WidowX)."""

from .policy import VLAPolicy, load_policy
from .processing import (
    center_crop_resize_tf,
    eval_prompt,
    libero_frame,
    resize_bicubic_pil,
)
from .queue import SUITE_PLACEMENTS, organize_experiments, run_queue

__all__ = [
    "SUITE_PLACEMENTS", "VLAPolicy", "center_crop_resize_tf", "eval_prompt", "libero_frame",
    "load_policy", "organize_experiments", "resize_bicubic_pil", "run_queue",
]
