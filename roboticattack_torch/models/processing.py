"""Processor API: `PrismaticImageProcessor` / `PrismaticProcessor`, the
host-side numpy + PIL code of the JAX package's `models/processing.py`.

Shapes match the reference's processing_prismatic.py:
  - image: resize (bicubic, antialias) -> center crop -> scale to [0,1] ->
    per-backbone normalize -> stack (:128-145). At the 224->224 operating
    point the crop is a no-op; on PIL inputs torchvision delegates resizing to
    PIL, so PIL here is bit-exact with the reference's eval path.
  - `letterbox` resize strategy pads to square with the (255-scaled) mean fill
    before resizing (:107-118).
  - processor call: tokenizer + image processor -> {input_ids, attention_mask,
    pixel_values} (:187-216).

pixel_values use the [B, 2, H, W, 3] tower stack that `vla_forward` takes;
`as_nchw6()` converts to the reference's 6-channel NCHW layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.constants import DINO_MEAN, DINO_STD, IMAGE_SIZE, PAD_TOKEN_ID, SIGLIP_MEAN, SIGLIP_STD
from ..utils.prompting import TextTokenizer, pad_batch


# Per-tower normalization stats (timm data configs the reference resolves at
# base_vision.py:137-139). DINO_MEAN/STD in utils/constants are the OpenVLA
# checkpoint's bf16-rounded copies of the ImageNet stats below.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)   # openai CLIP
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
INCEPTION_MEAN = (0.5, 0.5, 0.5)                   # siglip + augreg-in1k ViTs
INCEPTION_STD = (0.5, 0.5, 0.5)


@dataclass
class PrismaticImageProcessor:
    image_size: int = IMAGE_SIZE
    image_resize_strategy: str = "resize-naive"  # or "letterbox" / "resize-crop"
    means: Tuple[Tuple[float, ...], ...] = (DINO_MEAN, SIGLIP_MEAN)
    stds: Tuple[Tuple[float, ...], ...] = (DINO_STD, SIGLIP_STD)

    def _letterbox(self, pil, mean):
        """Pad to square with THIS tower's channel means scaled to [0, 255] —
        the reference builds one letterbox transform per tower, each with its
        own fill (base_vision.py:170-179; dinosiglip_vit.py:99-110)."""
        from PIL import ImageOps

        w, h = pil.size
        if w == h:
            return pil
        fill = tuple(int(m * 255) for m in mean)
        side = max(w, h)
        pad_w, pad_h = (side - w) // 2, (side - h) // 2
        return ImageOps.expand(pil, border=(pad_w, pad_h, side - w - pad_w, side - h - pad_h), fill=fill)

    def _geometry(self, pil):
        """Resize geometry shared by all towers (fill-independent)."""
        from PIL import Image

        if self.image_resize_strategy == "resize-crop":
            # Resize(shorter side -> S) + CenterCrop(S), the reference's
            # default timm transform (base_vision.py:144-168). Exact
            # torchvision semantics: the long side truncates
            # (F.resize size-int branch), the crop origin rounds
            # (F.center_crop).
            s = self.image_size
            w, h = pil.size
            if w <= h:
                nw, nh = s, int(s * h / w)
            else:
                nw, nh = int(s * w / h), s
            pil = pil.resize((nw, nh), Image.BICUBIC)
            left, top = int(round((nw - s) / 2.0)), int(round((nh - s) / 2.0))
            return pil.crop((left, top, left + s, top + s))
        return pil.resize((self.image_size, self.image_size), Image.BICUBIC)

    def apply_transform(self, image) -> np.ndarray:
        """PIL image or uint8 HWC array -> [n_towers, H, W, 3] float32 stacked
        normalized pixel values."""
        from PIL import Image

        pil = image if isinstance(image, Image.Image) else Image.fromarray(np.asarray(image))
        pil = pil.convert("RGB")
        letterbox = self.image_resize_strategy == "letterbox"
        stacked = []
        shared = None if letterbox else np.asarray(self._geometry(pil), np.float32) / 255.0
        for mean, std in zip(self.means, self.stds):
            arr = shared
            if arr is None:  # letterbox: per-tower fill color
                arr = np.asarray(self._geometry(self._letterbox(pil, mean)), np.float32) / 255.0
            stacked.append((arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32))
        return np.stack(stacked, axis=0)

    __call__ = apply_transform


@dataclass
class PrismaticProcessor:
    tokenizer: TextTokenizer
    image_processor: PrismaticImageProcessor = field(default_factory=PrismaticImageProcessor)

    def __call__(
        self,
        text: Union[str, Sequence[str]],
        images,
        pad_to: Optional[int] = None,
    ) -> dict:
        texts: List[str] = [text] if isinstance(text, str) else list(text)
        image_list = images if isinstance(images, (list, tuple)) else [images]
        assert len(texts) == len(image_list), "text/image batch mismatch"

        ids = [np.asarray(self.tokenizer.encode(t, add_bos=True), np.int32) for t in texts]
        if pad_to is not None:
            ids = [
                np.concatenate([s, np.full(max(0, pad_to - len(s)), PAD_TOKEN_ID, np.int32)])
                for s in ids
            ]
        input_ids = pad_batch(ids, PAD_TOKEN_ID)
        attention_mask = (input_ids != PAD_TOKEN_ID).astype(np.int32)
        pixel_values = np.stack([self.image_processor.apply_transform(im) for im in image_list])
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "pixel_values": pixel_values,  # [B, 2, H, W, 3]
        }

    @staticmethod
    def as_nchw6(pixel_values: np.ndarray) -> np.ndarray:
        """[B, 2, H, W, 3] -> the reference's [B, 6, H, W] channel stack."""
        b, two, h, w, c = pixel_values.shape
        return pixel_values.transpose(0, 1, 4, 2, 3).reshape(b, two * c, h, w)
