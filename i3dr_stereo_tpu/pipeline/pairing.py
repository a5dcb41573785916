"""Host-side frame pairing + batching.

The reference pairs the four streams (L/R image + L/R camera_info) with
``message_filters::Synchronizer<ApproximateTime>``
(generate_disparity.cpp:68-70, 990-997). Camera infos are static here
(carried by the pipeline), so pairing reduces to the two image streams:
a timestamp-bucketed queue that emits the closest-stamped (left, right)
pair within ``slop`` seconds, dropping stale frames — the ApproximateTime
policy's behavior for two topics.

The batcher then packs pairs into fixed-size (B, H, W) device batches —
the unit the device pipeline consumes (static shapes; padding replicates the
last frame and is masked out of the results by ``count``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Stamped:
    stamp: float
    data: np.ndarray
    seq: int = 0


class ApproximateTimeSync:
    """Two-stream closest-stamp pairing within a slop window."""

    def __init__(self, slop: float = 0.05, queue_size: int = 10):
        self.slop = slop
        self.queue_size = queue_size
        self._left: Deque[Stamped] = deque()
        self._right: Deque[Stamped] = deque()
        self._emitted: List[Tuple[Stamped, Stamped]] = []

    def push_left(self, stamp: float, data, seq: int = 0) -> None:
        self._left.append(Stamped(stamp, data, seq))
        self._trim(self._left)
        self._try_match()

    def push_right(self, stamp: float, data, seq: int = 0) -> None:
        self._right.append(Stamped(stamp, data, seq))
        self._trim(self._right)
        self._try_match()

    def _trim(self, q: Deque[Stamped]) -> None:
        while len(q) > self.queue_size:
            q.popleft()

    def _try_match(self) -> None:
        while self._left and self._right:
            l = self._left[0]
            # closest right frame to the oldest left frame
            best_i, best_dt = None, None
            for i, r in enumerate(self._right):
                dt = abs(r.stamp - l.stamp)
                if best_dt is None or dt < best_dt:
                    best_i, best_dt = i, dt
            if best_dt is not None and best_dt <= self.slop:
                # wait if a later right frame could still be closer
                newest_r = self._right[-1]
                if newest_r.stamp < l.stamp and len(self._right) < self.queue_size:
                    return  # right stream still behind; wait for more
                r = self._right[best_i]
                for _ in range(best_i + 1):
                    self._right.popleft()
                self._left.popleft()
                self._emitted.append((l, r))
            else:
                # no candidate within slop: drop whichever stream lags
                if self._right and self._right[-1].stamp > l.stamp + self.slop:
                    self._left.popleft()
                else:
                    return

    def pop_pairs(self) -> List[Tuple[Stamped, Stamped]]:
        out, self._emitted = self._emitted, []
        return out


@dataclasses.dataclass
class Batch:
    left: np.ndarray     # (B, H, W)
    right: np.ndarray
    stamps: np.ndarray   # (B,)
    count: int           # valid frames (<= B); rest is padding


class FrameBatcher:
    """Packs synced pairs into fixed-size batches for the device."""

    def __init__(self, batch_size: int = 1, *, pad: bool = True):
        self.batch_size = batch_size
        self.pad = pad
        self._pairs: List[Tuple[Stamped, Stamped]] = []

    def push(self, left: Stamped, right: Stamped) -> Optional[Batch]:
        self._pairs.append((left, right))
        if len(self._pairs) >= self.batch_size:
            return self.flush()
        return None

    def flush(self) -> Optional[Batch]:
        if not self._pairs:
            return None
        pairs, self._pairs = self._pairs[: self.batch_size], self._pairs[self.batch_size:]
        count = len(pairs)
        if self.pad and count < self.batch_size:
            pairs = pairs + [pairs[-1]] * (self.batch_size - count)
        left = np.stack([p[0].data for p in pairs])
        right = np.stack([p[1].data for p in pairs])
        stamps = np.array([p[0].stamp for p in pairs])
        return Batch(left=left, right=right, stamps=stamps, count=count)


def pair_streams(left_stream: Iterator[Stamped], right_stream: Iterator[Stamped],
                 slop: float = 0.05) -> Iterator[Tuple[Stamped, Stamped]]:
    """Convenience: pair two finite iterators of stamped frames."""
    sync = ApproximateTimeSync(slop=slop)
    li = iter(left_stream)
    ri = iter(right_stream)
    l_done = r_done = False
    while not (l_done and r_done):
        if not l_done:
            try:
                s = next(li)
                sync.push_left(s.stamp, s.data, s.seq)
            except StopIteration:
                l_done = True
        if not r_done:
            try:
                s = next(ri)
                sync.push_right(s.stamp, s.data, s.seq)
            except StopIteration:
                r_done = True
        yield from sync.pop_pairs()
