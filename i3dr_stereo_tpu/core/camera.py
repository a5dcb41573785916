"""Camera models, stereo rigs and reprojection geometry.

JAX analog of the reference's calibration plumbing:

- ROS ``CameraInfo`` (K, D, R, P) handling spread across
  ``scripts/yaml2CameraInfo.py:29-49`` and
  ``image_geometry::StereoCameraModel`` (generate_disparity.cpp:641)
  becomes a pair of immutable pytree dataclasses.
- The Q reprojection matrix built per-frame in the reference
  (``calc_q``, generate_disparity.cpp:501-526 and
  disparity_to_depth.cpp:62-85) is computed **once** per calibration here
  and carried as a small array.

All geometry is stored as float64 numpy on the host (calibration-time
precision), converted to ``jnp`` float32 only when entering jitted code.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

try:  # PyYAML is baked in; keep import local so core works without it.
    import yaml
except Exception:  # pragma: no cover
    yaml = None


def _as_matrix(data: Any, rows: int, cols: int) -> np.ndarray:
    arr = np.asarray(data, dtype=np.float64).reshape(rows, cols)
    return arr


@dataclasses.dataclass(frozen=True)
class CameraModel:
    """A single (possibly distorted) pinhole camera.

    Mirrors the ROS CameraInfo fields the reference consumes
    (yaml2CameraInfo.py:33-40): intrinsics ``K`` (3x3), plumb-bob
    distortion ``D`` (k1, k2, p1, p2, k3), rectification rotation ``R``
    (3x3) and rectified projection ``P`` (3x4).
    """

    width: int
    height: int
    K: np.ndarray  # (3, 3) intrinsics of the *raw* camera
    D: np.ndarray  # (n,) plumb_bob distortion, usually n == 5
    R: np.ndarray  # (3, 3) rectification rotation
    P: np.ndarray  # (3, 4) projection after rectification

    # --- rectified intrinsics -------------------------------------------------
    @property
    def fx(self) -> float:
        return float(self.P[0, 0])

    @property
    def fy(self) -> float:
        return float(self.P[1, 1])

    @property
    def cx(self) -> float:
        return float(self.P[0, 2])

    @property
    def cy(self) -> float:
        return float(self.P[1, 2])

    @property
    def Tx(self) -> float:
        """Baseline term of P: P[0,3] = -fx * B for the right camera."""
        return float(self.P[0, 3])

    def validate(self) -> "CameraModel":
        assert self.K.shape == (3, 3), self.K.shape
        assert self.R.shape == (3, 3), self.R.shape
        assert self.P.shape == (3, 4), self.P.shape
        assert self.D.ndim == 1
        return self

    # --- constructors ---------------------------------------------------------
    @staticmethod
    def ideal(width: int, height: int, fx: float, *, cx: float | None = None,
              cy: float | None = None, tx: float = 0.0) -> "CameraModel":
        """Distortion-free, already-rectified camera (synthetic rigs)."""
        cx = width / 2.0 if cx is None else cx
        cy = height / 2.0 if cy is None else cy
        K = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1.0]])
        P = np.hstack([K, np.array([[tx], [0.0], [0.0]])])
        return CameraModel(width, height, K, np.zeros(5), np.eye(3), P)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "CameraModel":
        """Parse the ROS calibration YAML schema (yaml2CameraInfo.py:33-40)."""
        cm = d["camera_matrix"]
        dist = d["distortion_coefficients"]
        rect = d["rectification_matrix"]
        proj = d["projection_matrix"]
        return CameraModel(
            width=int(d["image_width"]),
            height=int(d["image_height"]),
            K=_as_matrix(cm["data"], cm.get("rows", 3), cm.get("cols", 3)),
            D=np.asarray(dist["data"], dtype=np.float64).reshape(-1),
            R=_as_matrix(rect["data"], rect.get("rows", 3), rect.get("cols", 3)),
            P=_as_matrix(proj["data"], proj.get("rows", 3), proj.get("cols", 4)),
        ).validate()

    @staticmethod
    def from_yaml(path: str) -> "CameraModel":
        if yaml is None:  # pragma: no cover
            raise RuntimeError("PyYAML unavailable")
        with open(path, "r") as f:
            return CameraModel.from_dict(yaml.safe_load(f))

    def to_dict(self) -> dict:
        return {
            "image_width": self.width,
            "image_height": self.height,
            "camera_matrix": {"rows": 3, "cols": 3, "data": self.K.reshape(-1).tolist()},
            "distortion_model": "plumb_bob",
            "distortion_coefficients": {"rows": 1, "cols": int(self.D.size),
                                        "data": self.D.reshape(-1).tolist()},
            "rectification_matrix": {"rows": 3, "cols": 3, "data": self.R.reshape(-1).tolist()},
            "projection_matrix": {"rows": 3, "cols": 4, "data": self.P.reshape(-1).tolist()},
        }


def calc_q(left: CameraModel, right: CameraModel) -> np.ndarray:
    """Build the 4x4 disparity-to-depth reprojection matrix Q.

    Same construction as the reference (disparity_to_depth.cpp:62-85;
    generate_disparity.cpp:501-526): baseline from the right projection
    matrix ``T = -P_r[0,3] / fx``; reprojection
    ``[X Y Z W]^T = Q [x y d 1]^T`` with ``W = (-d + (cx - cx'))/T``.
    """
    fx = left.fx
    cx, cy = left.cx, left.cy
    cx2 = right.cx
    T = -right.Tx / right.fx  # metres; positive baseline
    if T == 0:
        raise ValueError("degenerate stereo rig: zero baseline (P_r[0,3] == 0)")
    Q = np.zeros((4, 4))
    Q[0, 0] = 1.0
    Q[0, 3] = -cx
    Q[1, 1] = 1.0
    Q[1, 3] = -cy
    Q[2, 3] = fx
    Q[3, 2] = 1.0 / T
    Q[3, 3] = -(cx - cx2) / T
    return Q


@dataclasses.dataclass(frozen=True)
class StereoRig:
    """Calibrated stereo pair. The unit every pipeline stage consumes."""

    left: CameraModel
    right: CameraModel

    @property
    def width(self) -> int:
        return self.left.width

    @property
    def height(self) -> int:
        return self.left.height

    @property
    def baseline(self) -> float:
        """Baseline in metres, T = -P_r[0,3]/fx (disparity_to_depth.cpp:78)."""
        return -self.right.Tx / self.right.fx

    @property
    def fx(self) -> float:
        return self.left.fx

    @property
    def Q(self) -> np.ndarray:
        return calc_q(self.left, self.right)

    def depth_to_disparity(self, depth: float) -> float:
        """d = fx * B / Z — used for the depth_max -> min_disparity clamp
        the reference applies (generate_disparity.cpp:449-452)."""
        return self.fx * self.baseline / depth

    def disparity_to_depth(self, disp: float) -> float:
        return self.fx * self.baseline / disp

    @staticmethod
    def synthetic(width: int = 640, height: int = 480, *, fx: float = 580.0,
                  baseline_m: float = 0.30) -> "StereoRig":
        """Ideal rectified rig used by tests and synthetic sources.

        Default baseline/f roughly match the reference's phobos-class rig
        (urdf/i3dr_stereo_camera.urdf.xacro baseline arg).
        """
        left = CameraModel.ideal(width, height, fx)
        right = CameraModel.ideal(width, height, fx, tx=-fx * baseline_m)
        return StereoRig(left, right)

    @staticmethod
    def from_yaml(left_path: str, right_path: str) -> "StereoRig":
        return StereoRig(CameraModel.from_yaml(left_path), CameraModel.from_yaml(right_path))
