"""Node-level equivalents of the reference's executables.

Each class re-creates one reference node's topic/service surface on the
in-process graph, backed by the fused device pipeline instead of separate
OS processes:

- :class:`GenerateDisparityNode` <- src/generate_disparity.cpp (topics
  image_rect/disparity, save_stereo service, 2 reconfigure servers,
  algorithm hot-swap)
- :class:`RectifyNode`           <- src/rectify.cpp (standalone
  rectification + save_rectified service)
- :class:`DisparityToDepthNode`  <- src/disparity_to_depth.cpp
- :class:`CropByDisparityNode`   <- src/crop_image_by_disparity.cpp
  (lazy: computes only when subscribed, cpp:91)
- :class:`CameraControlNode`     <- src/tiscamera_ctrl.py (property
  services, settings reconfigure, laser-split republish)
- :class:`TriggerNode`           <- src/tiscamera_trigger.py (Bool topic)
- :func:`warmup_matchers`        <- src/init_stereo_matchers.cpp (ahead-
  of-time compile of the selected backend = the CUDA-JIT warmup analog)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from i3dr_stereo_tpu.bridge.graph import Graph, Node
from i3dr_stereo_tpu.bridge.reconfigure import (
    CAMERA_SCHEMA,
    DISPARITY_SCHEMA,
    POINTCLOUD_SCHEMA,
    ReconfigureServer,
    apply_camera_params,
    apply_cloud_params,
    apply_flat_params,
)
from i3dr_stereo_tpu.bridge.services import (
    SaveRectifiedRequest,
    SaveRectifiedResponse,
    SaveStereoRequest,
    SaveStereoResponse,
)
from i3dr_stereo_tpu.config.params import CameraSettings, MatcherConfig, PointCloudConfig
from i3dr_stereo_tpu.core.camera import StereoRig
from i3dr_stereo_tpu.io.savers import save_stereo, save_png
from i3dr_stereo_tpu.ops.depth import pointcloud_to_numpy
from i3dr_stereo_tpu.pipeline.pairing import ApproximateTimeSync
from i3dr_stereo_tpu.pipeline.stereo_pipeline import StereoPipeline


class GenerateDisparityNode(Node):
    """The central pipeline node (generate_disparity.cpp).

    Subscribes <ns>/left|right/image_raw, publishes
    <ns>/left|right/image_rect, <ns>/disparity, <ns>/depth, <ns>/points2
    (the last two were a separate process in the reference — here they
    are free outputs of the same fused program)."""

    def __init__(self, graph: Graph, rig: StereoRig, config: MatcherConfig,
                 cloud: PointCloudConfig = PointCloudConfig(),
                 namespace: str = "/stereo", name: str = "generate_disparity",
                 rectify: bool = True, slop: float = 0.05, remaps=None):
        super().__init__(graph, name, namespace, remaps or {})
        self.pipeline = StereoPipeline(rig=rig, config=config, cloud=cloud,
                                       rectify_inputs=rectify,
                                       compute_crop=False)
        self._sync = ApproximateTimeSync(slop=slop)
        self._last = None  # cached state for save_stereo
        self.frames_processed = 0
        self.frames_dropped = 0

        self.subscribe("left/image_raw", self._on_left)
        self.subscribe("right/image_raw", self._on_right)
        self.advertise_service("save_stereo", self.save_stereo)
        # two reconfigure servers, like the reference (cpp:968-977)
        self.disparity_cfg = ReconfigureServer(
            DISPARITY_SCHEMA, self._on_disparity_reconf,
            initial=_config_to_flat(self.pipeline.config))
        self.cloud_cfg = ReconfigureServer(
            POINTCLOUD_SCHEMA, self._on_cloud_reconf,
            initial=dataclasses.asdict(cloud))

    # -- topic callbacks ------------------------------------------------------
    def _on_left(self, stamp, img):
        self._sync.push_left(stamp, img)
        self._drain()

    def _on_right(self, stamp, img):
        self._sync.push_right(stamp, img)
        self._drain()

    def _drain(self):
        for l, r in self._sync.pop_pairs():
            self._process(l.stamp, l.data, r.data)

    def _process(self, stamp, left, right):
        try:
            res = self.pipeline.process(left, right)
        except Exception as e:  # match failure: drop frame, keep running
            self.frames_dropped += 1
            self.publish("match_errors", stamp, repr(e))
            return
        self.frames_processed += 1
        self._last = (stamp, left, right, res)
        self.publish("left/image_rect", stamp, np.asarray(res.rect_left))
        self.publish("right/image_rect", stamp, np.asarray(res.rect_right))
        self.publish("disparity", stamp, {
            "disparity": np.asarray(res.disparity),
            "valid": np.asarray(res.valid),
            "min_disparity": self.pipeline.config.min_disparity,
            "disparity_range": self.pipeline.config.disparity_range,
            "f": self.pipeline.rig.fx,
            "T": self.pipeline.rig.baseline,
        })
        if res.depth is not None:
            self.publish("depth", stamp, np.asarray(res.depth))
        if res.points is not None:
            self.publish("points2", stamp,
                         {k: np.asarray(v) for k, v in res.points.items()})

    # -- reconfigure ----------------------------------------------------------
    def _on_disparity_reconf(self, flat, changed):
        # apply only the keys that changed: re-coercing the whole flat
        # dict would clamp unrelated fields through the schema's types
        # (e.g. engine speckle_range 0.5 -> int 0). No cache handling:
        # numeric fields are traced arguments of the compiled step
        # (StereoPipeline.DYN_FIELDS), structural ones re-key the jit
        # cache — live tuning never rebuilds (cf. I3DRSGM.cpp:630-654)
        self.pipeline.config = apply_flat_params(
            self.pipeline.config, {k: flat[k] for k in changed})

    def _on_cloud_reconf(self, flat, changed):
        self.pipeline.cloud = apply_cloud_params(
            self.pipeline.cloud, {k: flat[k] for k in changed})

    # -- services -------------------------------------------------------------
    def save_stereo(self, req: SaveStereoRequest) -> SaveStereoResponse:
        if self._last is None:
            return SaveStereoResponse(res="no frame yet", ok=False)
        stamp, left, right, res = self._last
        xyz = rgb = None
        if res.points is not None:
            pts = {k: np.asarray(v) for k, v in res.points.items()}
            xyz, rgb = pointcloud_to_numpy(pts)
        paths = save_stereo(
            req.folderpath, seq=self.frames_processed,
            left_raw=np.asarray(left), right_raw=np.asarray(right),
            left_rect=np.asarray(res.rect_left),
            right_rect=np.asarray(res.rect_right),
            disparity=np.asarray(res.disparity), valid=np.asarray(res.valid),
            points_xyz=xyz, points_rgb=rgb,
            save_rectified=req.save_rectified,
            save_disparity=req.save_disparity,
            save_point_cloud=req.save_point_cloud,
            binary_ply=self.pipeline.cloud.save_points_as_binary)
        return SaveStereoResponse(res="saved", ok=True, paths=paths)


class RectifyNode(Node):
    """Standalone rectification (rectify.cpp): image_raw -> image_rect
    with a save_rectified service. Used for the no-laser stream and bag
    replay in the reference (stereo_matcher.launch:180-185)."""

    def __init__(self, graph: Graph, rig: StereoRig, namespace="/stereo",
                 name="rectify", remaps=None):
        super().__init__(graph, name, namespace, remaps or {})
        from i3dr_stereo_tpu.ops.rectify import make_rectify_map, remap

        self._maps = (make_rectify_map(rig.left), make_rectify_map(rig.right))
        self._remap = remap
        self._last = {}
        self.subscribe("left/image_raw", lambda s, d: self._on(0, "left", s, d))
        self.subscribe("right/image_raw", lambda s, d: self._on(1, "right", s, d))
        self.advertise_service("save_rectified", self.save_rectified)

    def _on(self, idx, side, stamp, img):
        out = np.asarray(self._remap(np.asarray(img, dtype=np.float32),
                                     self._maps[idx]))
        self._last[side] = out
        self.publish(f"{side}/image_rect", stamp, out)

    def save_rectified(self, req: SaveRectifiedRequest) -> SaveRectifiedResponse:
        if not self._last:
            return SaveRectifiedResponse(res="no frame yet", ok=False)
        import os

        os.makedirs(req.folderpath, exist_ok=True)
        paths = {}
        for side, img in self._last.items():
            paths[side] = save_png(
                os.path.join(req.folderpath, f"{side}_rect.png"), img)
        return SaveRectifiedResponse(res="saved", ok=True, paths=paths)


class DisparityToDepthNode(Node):
    """disparity_to_depth.cpp as a subscriber node (for graphs that run
    the matcher without fused depth, e.g. external disparity sources).

    Disparity and rect-left are ApproximateTime-synced by stamp before a
    cloud is produced, matching the reference's 3-way synchronizer of
    disparity + rect + infos (disparity_to_depth.cpp:55-57, 274-280; the
    camera infos are static here — the rig passed at construction). An
    out-of-order rect frame therefore can no longer color/mask the cloud
    of a different frame."""

    def __init__(self, graph: Graph, rig: StereoRig, namespace="/stereo",
                 name="disparity_to_depth", depth_max=10.0, depth_min=0.0,
                 slop=0.05, remaps=None):
        super().__init__(graph, name, namespace, remaps or {})
        import jax
        import jax.numpy as jnp

        from i3dr_stereo_tpu.ops.depth import disparity_to_depth, disparity_to_pointcloud
        from i3dr_stereo_tpu.pipeline.pairing import ApproximateTimeSync

        Q = jnp.asarray(rig.Q, dtype=np.float32)
        self.depth_max, self.depth_min = depth_max, depth_min
        self._depth = jax.jit(lambda d, v: disparity_to_depth(
            d, v, Q, self.depth_min, self.depth_max))
        self._points = jax.jit(lambda d, v, g: disparity_to_pointcloud(
            d, v, Q, g, self.depth_min, self.depth_max))
        self._sync = ApproximateTimeSync(slop=slop)
        self.subscribe("left/image_rect", self._on_rect)
        self.subscribe("disparity", self._on_disp)

    def _on_rect(self, stamp, img):
        self._sync.push_right(stamp, np.asarray(img, dtype=np.float32))
        self._drain()

    def _on_disp(self, stamp, msg):
        # depth needs no rect; publish it immediately (reference parity:
        # the depth image is a pure function of disparity + Q)
        d = np.asarray(msg["disparity"], dtype=np.float32)
        v = np.asarray(msg["valid"])
        depth, ok = self._depth(d, v)
        self.publish("depth", stamp, np.asarray(depth))
        self._sync.push_left(stamp, (d, v))
        self._drain()

    def _drain(self):
        for disp_msg, rect in self._sync.pop_pairs():
            d, v = disp_msg.data
            if rect.data.shape != d.shape:
                continue
            pts = self._points(d, v, rect.data)
            self.publish("points2", disp_msg.stamp,
                         {k: np.asarray(x) for k, x in pts.items()})


class CropByDisparityNode(Node):
    """crop_image_by_disparity.cpp: left_rect masked by valid disparity;
    lazy — computes only while someone subscribes (cpp:91)."""

    def __init__(self, graph: Graph, namespace="/stereo",
                 name="crop_image_by_disparity", remaps=None):
        super().__init__(graph, name, namespace, remaps or {})
        import jax

        from i3dr_stereo_tpu.ops.depth import crop_by_disparity

        self._crop = jax.jit(crop_by_disparity)
        self._rect = None
        self.subscribe("left/image_rect", self._on_rect)
        self.subscribe("disparity", self._on_disp)

    def _on_rect(self, stamp, img):
        self._rect = np.asarray(img, dtype=np.float32)

    def _on_disp(self, stamp, msg):
        if self.num_subscribers("left/image_rect_disp_cropped") == 0:
            return  # lazy
        if self._rect is None:
            return
        out = self._crop(self._rect, np.asarray(msg["disparity"]),
                         np.asarray(msg["valid"]))
        self.publish("left/image_rect_disp_cropped", stamp, np.asarray(out))


class TriggerNode(Node):
    """tiscamera_trigger.py: publishes laser on/off Booleans. The serial
    port is replaced by any callable source (tests drive it directly)."""

    def __init__(self, graph: Graph, name="tiscamera_trigger",
                 topic: str = "/phobos_nuclear_trigger"):
        super().__init__(graph, name, "")
        self._topic = topic

    def fire(self, stamp: float, laser_on: bool):
        self.publish(self._topic, stamp, bool(laser_on))


class CameraControlNode(Node):
    """tiscamera_ctrl.py: per-camera property services
    (tiscam_<serial>_set_*), settings reconfigure server and the
    laser-split republisher driven by the trigger topic."""

    def __init__(self, graph: Graph, serial: str, namespace="/stereo/left",
                 name=None, settings: CameraSettings = CameraSettings(),
                 split_laser: bool = False,
                 trigger_topic: str = "/phobos_nuclear_trigger",
                 apply_fn: Optional[Callable[[CameraSettings], None]] = None):
        super().__init__(graph, name or f"tiscamera_ctrl_{serial}", namespace)
        self.serial = serial
        self.settings = settings.clamp()
        self._apply = apply_fn or (lambda s: None)
        self._laser_on = False

        for prop in ("brightness", "exposure", "gain", "exposure_auto", "gain_auto"):
            self.graph.advertise_service(
                f"/tiscam_{serial}_set_{prop}",
                (lambda p: lambda req: self._set_prop(p, req))(prop))
        self.reconf = ReconfigureServer(CAMERA_SCHEMA, self._on_reconf,
                                        initial=_settings_to_flat(self.settings))
        if split_laser:
            self.graph.subscribe(trigger_topic, self._on_trigger)
            self.subscribe("image_raw", self._on_image)

    def _set_prop(self, prop, req):
        from i3dr_stereo_tpu.bridge.services import SetResponse

        self.settings = dataclasses.replace(
            self.settings, **{prop: getattr(req, "value")}).clamp()
        self._apply(self.settings)
        return SetResponse(res=f"{prop}={getattr(self.settings, prop)}", ok=True)

    def _on_reconf(self, flat, changed):
        self.settings = apply_camera_params(self.settings, flat)
        self._apply(self.settings)

    def _on_trigger(self, stamp, laser_on: bool):
        self._laser_on = bool(laser_on)

    def _on_image(self, stamp, img):
        suffix = "with_laser" if self._laser_on else "no_laser"
        self.publish(f"image_raw_{suffix}", stamp, img)


def warmup_matchers(config: MatcherConfig, shape=(32, 32)) -> bool:
    """init_stereo_matchers.cpp analog: push a small zero pair through the
    configured backend to trigger compilation before the first real frame."""
    from i3dr_stereo_tpu.matchers import create_matcher

    m = create_matcher(config.replace(disparity_range=16, speckle_size=0))
    res = m.match(np.zeros(shape, np.float32), np.zeros(shape, np.float32))
    return res.disparity.shape == shape


# -- helpers -----------------------------------------------------------------

def _config_to_flat(cfg: MatcherConfig) -> dict:
    return {
        "stereo_algorithm": int(cfg.algorithm),
        "prefilter_size": cfg.prefilter_size,
        "prefilter_cap": cfg.prefilter_cap,
        "correlation_window_size": cfg.window_size,
        "min_disparity": cfg.min_disparity,
        "disparity_range": cfg.disparity_range,
        "uniqueness_ratio": cfg.uniqueness_ratio,
        "texture_threshold": int(cfg.texture_threshold),
        "speckle_size": cfg.speckle_size,
        "speckle_range": int(cfg.speckle_range),
        "fullDP": cfg.num_directions == 8,
        "p1": cfg.p1,
        "p2": cfg.p2,
        "disp12MaxDiff": int(max(cfg.disp12_max_diff, 0)),
        "interp": cfg.interp,
    }


def _settings_to_flat(s: CameraSettings) -> dict:
    return {"Brightness": s.brightness, "Exposure": s.exposure, "Gain": s.gain,
            "Exposure_Auto": s.exposure_auto, "Gain_Auto": s.gain_auto}
