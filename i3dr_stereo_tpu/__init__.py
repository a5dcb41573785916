"""i3dr_stereo_tpu — a stereo depth engine in JAX for NVIDIA GPUs.

A ground-up re-design of the capabilities of the reference ROS package
``i3drobotics/i3dr_stereo_camera-ros`` (camera capture -> rectification ->
stereo matching -> depth / point cloud, with live parameter tuning), built
on JAX/XLA/Pallas:

- The reference's process-per-stage ROS graph (generate_disparity,
  rectify, disparity_to_depth, crop_image_by_disparity as separate OS
  processes wired by TCPROS topics) becomes a single fused, jitted
  pipeline executing on the device (:mod:`i3dr_stereo_tpu.pipeline`).
- The reference's six matcher backends (OpenCV BM / SGBM, CUDA
  BM / BP / CSBP, licensed I3DRSGM) become one functional engine with
  selectable cost/aggregation configs (:mod:`i3dr_stereo_tpu.matchers`),
  whose SGM recurrence is a Pallas kernel on the GPU
  (:mod:`i3dr_stereo_tpu.ops`).
- Scaling is a `jax.sharding.Mesh` (batch x spatial) with halo exchange
  for cross-tile SGM paths (:mod:`i3dr_stereo_tpu.dist`) instead of the
  reference's multi-process / multi-GPU arrangement.
- The ROS pub/sub + services + dynamic_reconfigure surface is a thin
  host-side shell (:mod:`i3dr_stereo_tpu.bridge`).
"""

__version__ = "0.1.0"

from i3dr_stereo_tpu.core.camera import (  # noqa: F401
    CameraModel,
    StereoRig,
    calc_q,
)
