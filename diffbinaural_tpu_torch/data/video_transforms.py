"""Video frame preprocessing — counterpart of
``diffbinaural_tpu/data/video_transforms.py`` (numpy and Pillow): the CLIP
preprocessing the encoders expect (bicubic resize of the shorter side ->
centre crop -> CLIP mean / std), plus the train-time augmentations a
FairPlay-style loader uses.  Pillow is imported where an image is touched;
without it :func:`pil_image` raises an ``ImportError`` that names it.
"""

from __future__ import annotations

import random
from typing import Sequence

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def pil_image():
    """``PIL.Image``; an ``ImportError`` naming Pillow without it."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            "decoding video frames needs Pillow (the PIL package), which is "
            "not installed") from exc
    return Image


def resize_shorter(img, size: int):
    Image = pil_image()
    w, h = img.size
    scale = size / min(w, h)
    return img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)


def center_crop(img, size: int):
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def random_crop(img, size: int, rng: random.Random):
    w, h = img.size
    left = rng.randint(0, max(w - size, 0))
    top = rng.randint(0, max(h - size, 0))
    return img.crop((left, top, left + size, top + size))


def random_horizontal_flip(img, rng: random.Random, p: float = 0.5):
    Image = pil_image()
    if rng.random() < p:
        return img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


def to_clip_tensor(img) -> np.ndarray:
    """PIL RGB → CLIP-normalised (3, H, W) float32."""
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr.transpose(2, 0, 1)


def preprocess_frame(img, size: int = 224, train: bool = False,
                     rng: random.Random | None = None) -> np.ndarray:
    """Full pipeline: resize → (random|center) crop → (flip) → normalise."""
    img = img.convert("RGB") if img.mode != "RGB" else img
    img = resize_shorter(img, size)
    if train and rng is not None:
        img = random_crop(img, size, rng)
        img = random_horizontal_flip(img, rng)
    else:
        img = center_crop(img, size)
    return to_clip_tensor(img)


def stack_clip(frames: Sequence[np.ndarray]) -> np.ndarray:
    """T × (3, H, W) → (3, T, H, W) (the encoders' frame-axis layout)."""
    return np.stack(frames, axis=1)
