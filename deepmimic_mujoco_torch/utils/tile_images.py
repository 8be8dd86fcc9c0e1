"""Image tiling for grid renders (port of
``deepmimic_mujoco_tpu/utils/tile_images.py``, the reference's
``tile_images``)."""

from __future__ import annotations

import numpy as np


def tile_images(img_nhwc: np.ndarray) -> np.ndarray:
    """(N, h, w, c) → one (H, W, c) grid image, N padded up to a square."""
    img_nhwc = np.asarray(img_nhwc)
    n, h, w, c = img_nhwc.shape
    new_height = int(np.ceil(np.sqrt(n)))
    new_width = int(np.ceil(float(n) / new_height))
    img_nhwc = np.array(
        list(img_nhwc)
        + [img_nhwc[0] * 0 for _ in range(n, new_height * new_width)])
    img_HWhwc = img_nhwc.reshape(new_height, new_width, h, w, c)
    img_HhWwc = img_HWhwc.transpose(0, 2, 1, 3, 4)
    return img_HhWwc.reshape(new_height * h, new_width * w, c)
