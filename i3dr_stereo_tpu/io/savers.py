"""On-demand persistence: the reference's save services, as functions.

- ``save_stereo`` service (generate_disparity.cpp:172-231,
  srv/SaveStereo.srv): writes raw/rectified PNGs, disparity PNG (x16
  fixed point) and the point cloud as PLY (binary or ASCII by flag —
  cfg/i3DR_pointCloud.cfg "save_points_as_binary").
- ``save_rectified`` service (rectify.cpp:47-79, srv/SaveRectified.srv).
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np


def save_png(path: str, image: np.ndarray) -> str:
    img = np.asarray(image)
    if img.dtype in (np.float32, np.float64):
        img = np.clip(img, 0, 255).astype(np.uint8)
    import cv2

    cv2.imwrite(path, img)
    return path


def save_disparity_png(path: str, disparity: np.ndarray,
                       valid: Optional[np.ndarray] = None,
                       scale: int = 16) -> str:
    """16-bit PNG of disparity x16 (the reference's fixed-point DPP
    convention); invalid -> 0."""
    d = np.asarray(disparity, dtype=np.float64) * scale
    if valid is not None:
        d = np.where(np.asarray(valid), d, 0.0)
    d = np.clip(d, 0, 65535).astype(np.uint16)
    import cv2

    cv2.imwrite(path, d)
    return path


def save_ply(path: str, xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
             binary: bool = False) -> str:
    """PLY point-cloud writer, ASCII or binary-little-endian, matching
    the pcl::io::savePLYFile outputs the reference produces."""
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    has_rgb = rgb is not None
    if has_rgb:
        rgb = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8).reshape(-1, 3)
        assert rgb.shape[0] == n

    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_rgb:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += ["end_header"]

    if binary:
        with open(path, "wb") as f:
            f.write(("\n".join(header) + "\n").encode())
            if has_rgb:
                rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
                rec["xyz"] = xyz
                rec["rgb"] = rgb
                f.write(rec.tobytes())
            else:
                f.write(xyz.astype("<f4").tobytes())
    else:
        with open(path, "w") as f:
            f.write("\n".join(header) + "\n")
            for i in range(n):
                if has_rgb:
                    f.write(f"{xyz[i,0]:.6f} {xyz[i,1]:.6f} {xyz[i,2]:.6f} "
                            f"{rgb[i,0]} {rgb[i,1]} {rgb[i,2]}\n")
                else:
                    f.write(f"{xyz[i,0]:.6f} {xyz[i,1]:.6f} {xyz[i,2]:.6f}\n")
    return path


def load_ply(path: str):
    """Minimal PLY reader (for tests / replay)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode().strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(h for h in header if h.startswith("element vertex")).split()[-1])
        has_rgb = any("red" in h for h in header)
        binary = any("binary" in h for h in header)
        if binary:
            if has_rgb:
                rec = np.frombuffer(f.read(), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)],
                                    count=n)
                return rec["xyz"].copy(), rec["rgb"].copy()
            xyz = np.frombuffer(f.read(4 * 3 * n), dtype="<f4").reshape(n, 3)
            return xyz.copy(), None
        rows = [f.readline().decode().split() for _ in range(n)]
        arr = np.array(rows, dtype=np.float64)
        xyz = arr[:, :3].astype(np.float32)
        rgb = arr[:, 3:6].astype(np.uint8) if has_rgb and arr.shape[1] >= 6 else None
        return xyz, rgb


def save_stereo(folderpath: str, *, seq: int = 0,
                left_raw=None, right_raw=None,
                left_rect=None, right_rect=None,
                disparity=None, valid=None,
                points_xyz=None, points_rgb=None,
                save_rectified: bool = True,
                save_disparity: bool = True,
                save_point_cloud: bool = True,
                binary_ply: bool = False) -> dict:
    """The save_stereo service body (generate_disparity.cpp:172-231):
    writes whatever was provided, returns the written paths."""
    os.makedirs(folderpath, exist_ok=True)
    out = {}
    tag = f"{seq:06d}"
    if left_raw is not None:
        out["left_raw"] = save_png(os.path.join(folderpath, f"left_raw_{tag}.png"), left_raw)
    if right_raw is not None:
        out["right_raw"] = save_png(os.path.join(folderpath, f"right_raw_{tag}.png"), right_raw)
    if save_rectified and left_rect is not None:
        out["left_rect"] = save_png(os.path.join(folderpath, f"left_rect_{tag}.png"), left_rect)
    if save_rectified and right_rect is not None:
        out["right_rect"] = save_png(os.path.join(folderpath, f"right_rect_{tag}.png"), right_rect)
    if save_disparity and disparity is not None:
        out["disparity"] = save_disparity_png(
            os.path.join(folderpath, f"disparity_{tag}.png"), disparity, valid)
    if save_point_cloud and points_xyz is not None:
        out["points"] = save_ply(os.path.join(folderpath, f"points_{tag}.ply"),
                                 points_xyz, points_rgb, binary=binary_ply)
    return out
