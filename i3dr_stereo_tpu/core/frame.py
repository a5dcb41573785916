"""Frame containers flowing through the pipeline.

The reference moves ``sensor_msgs/Image`` + ``CameraInfo`` quadruplets
between processes and re-pairs them with an ApproximateTime synchronizer
(generate_disparity.cpp:68-70, 990-997). Here a frame is a plain pytree:
images are device arrays with a static (H, W) shape so everything stays
jittable, and the timestamp rides along as data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Frame:
    """One image: mono float32 [0, 255] (H, W) or (H, W, 3) color."""

    image: jax.Array
    stamp: jax.Array  # scalar float64/float32 seconds
    seq: jax.Array    # scalar int32 sequence number

    @staticmethod
    def create(image, stamp: float = 0.0, seq: int = 0) -> "Frame":
        return Frame(
            image=jnp.asarray(image),
            stamp=jnp.asarray(stamp, dtype=jnp.float32),
            seq=jnp.asarray(seq, dtype=jnp.int32),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StereoFrame:
    """A time-paired left/right image pair (post frame-pairing)."""

    left: jax.Array   # (H, W) or (B, H, W)
    right: jax.Array
    stamp: jax.Array
    seq: jax.Array

    @staticmethod
    def create(left, right, stamp: float = 0.0, seq: int = 0) -> "StereoFrame":
        left = jnp.asarray(left)
        right = jnp.asarray(right)
        assert left.shape == right.shape, (left.shape, right.shape)
        return StereoFrame(
            left=left,
            right=right,
            stamp=jnp.asarray(stamp, dtype=jnp.float32),
            seq=jnp.asarray(seq, dtype=jnp.int32),
        )

    @property
    def height(self) -> int:
        return self.left.shape[-2]

    @property
    def width(self) -> int:
        return self.left.shape[-1]


def to_mono_f32(image) -> jnp.ndarray:
    """uint8/float, mono or BGR/RGB -> float32 mono in [0, 255].

    Replaces the reference's per-frame cvtColor-to-mono8 conversion
    (generate_disparity.cpp:407-416) with a fused luma dot-product.
    """
    x = jnp.asarray(image)
    if x.ndim == 3 and x.shape[-1] == 3:
        # ITU-R BT.601 luma, matching cv::cvtColor BGR2GRAY weights; an
        # elementwise sum, not a dot, so no device lowers it to TF32
        x = x.astype(jnp.float32)
        x = x[..., 0] * 0.114 + x[..., 1] * 0.587 + x[..., 2] * 0.299
    return x.astype(jnp.float32)


def to_uint8(image) -> np.ndarray:
    x = np.asarray(image)
    return np.clip(x, 0, 255).astype(np.uint8)
