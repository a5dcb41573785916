"""Camera driver processes: the L0/L1 capture layer.

Reference shape (src/tiscamera.py + src/tiscamera_ctrl.py): a driver
process owns the camera, pushes frames into a shared-memory segment
(`shmsink /tmp/ros_mem_<serial>`), a control node exposes property
services and a connect-retry loop, and a serial trigger node publishes
laser on/off Booleans.

Here the segment is the native FrameRing; drivers are small processes
(or threads) writing into it, and :class:`ShmCameraPublisher` bridges
ring -> graph topics on the pipeline host. Real GenICam/GigE SDKs are
not assumed on the pipeline host, so the hardware end implements the
same ``push(stamp, frame)`` contract.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np

from i3dr_stereo_tpu.bridge.graph import Graph, Node
from i3dr_stereo_tpu.native.shm import FrameRing
from i3dr_stereo_tpu.utils.logging import get_logger

log = get_logger("drivers")


@dataclasses.dataclass
class ConnectRetry:
    """The reference's camera connect-retry loop (tiscamera_ctrl.py:39-53):
    retry `connect` every `interval` seconds until success or timeout."""

    interval: float = 3.0
    timeout: float = 30.0

    def run(self, connect: Callable[[], object]) -> object:
        deadline = time.monotonic() + self.timeout
        attempt = 0
        while True:
            attempt += 1
            try:
                return connect()
            except Exception as e:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"camera connect failed after {attempt} attempts") from e
                log.warning("connect attempt %d failed (%s); retrying in %.1fs",
                            attempt, e, self.interval)
                time.sleep(self.interval)


class SyntheticRingDriver:
    """A 'camera process': renders synthetic frames into a FrameRing at a
    fixed fps (stands in for the GStreamer tcamsrc pipeline)."""

    def __init__(self, ring: FrameRing, frame_fn: Callable[[int], np.ndarray],
                 fps: float = 5.0):
        self.ring = ring
        self.frame_fn = frame_fn
        self.fps = fps
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, n_frames: Optional[int] = None) -> None:
        def run():
            i = 0
            # bounded runs always complete their n_frames (stop() only
            # interrupts free-running capture)
            while n_frames is not None or not self._stop.is_set():
                if n_frames is not None and i >= n_frames:
                    break
                self.ring.push(i / self.fps, self.frame_fn(i), seq=i)
                i += 1
                if n_frames is None:
                    time.sleep(1.0 / self.fps)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


class ShmCameraPublisher(Node):
    """Bridges a FrameRing into graph topics: the gscam analog.

    ``pump()`` drains the ring and publishes each frame on
    ``<ns>/image_raw`` (and routes laser-split streams when enabled,
    mirroring tiscamera_ctrl.py:108-116)."""

    def __init__(self, graph: Graph, ring: FrameRing, namespace: str,
                 name: str = "shm_camera", split_laser: bool = False,
                 trigger_topic: str = "/phobos_nuclear_trigger"):
        super().__init__(graph, name, namespace)
        self.ring = ring
        self._split = split_laser
        self._laser_on = False
        if split_laser:
            self.graph.subscribe(trigger_topic, self._on_trigger)

    def _on_trigger(self, stamp, on: bool):
        self._laser_on = bool(on)

    def pump(self, max_frames: int = 64) -> int:
        n = 0
        while n < max_frames:
            item = self.ring.pop()
            if item is None:
                break
            stamp, seq, frame = item
            self.publish("image_raw", stamp, frame)
            if self._split:
                suffix = "with_laser" if self._laser_on else "no_laser"
                self.publish(f"image_raw_{suffix}", stamp, frame)
            n += 1
        return n


class SerialTriggerReader:
    """tiscamera_trigger.py analog: reads 'Laser:ON'/'Laser:OFF' lines
    from a byte stream (a serial port when pyserial + hardware exist —
    any file-like works) and publishes Booleans; auto-reopens on failure
    (tiscamera_trigger.py:56-63)."""

    def __init__(self, open_fn: Callable[[], object], publish: Callable[[float, bool], None],
                 reopen_delay: float = 1.0):
        self.open_fn = open_fn
        self.publish = publish
        self.reopen_delay = reopen_delay
        self._stop = threading.Event()

    def run_once(self, stream) -> int:
        n = 0
        for raw in stream:
            if self._stop.is_set():
                break
            line = raw.decode() if isinstance(raw, bytes) else str(raw)
            line = line.strip()
            if line == "Laser:ON":
                self.publish(time.time(), True)
                n += 1
            elif line == "Laser:OFF":
                self.publish(time.time(), False)
                n += 1
        return n

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                stream = self.open_fn()
            except Exception as e:
                log.warning("trigger open failed (%s); retrying", e)
                time.sleep(self.reopen_delay)
                continue
            try:
                self.run_once(stream)
                return
            except Exception as e:
                log.warning("trigger read failed (%s); reopening", e)
                time.sleep(self.reopen_delay)

    def stop(self) -> None:
        self._stop.set()
