"""Device-resident frame ring buffer (counterpart of
nicer_slam_tpu/slam/frame_store.py).

Every keyframe (and a rolling window of recent frames) is staged once into
fixed device tensors; mapping gathers its per-iteration pixel batches on
the device. Per pixel: rgb uint8 (3 B), mono depth f16 (2 B), mono normal
f16×3 (6 B), gt depth f16 (2 B), mask bool (1 B) = 14 B.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .mapping import FrameData


class FrameStore:
    def __init__(self, H: int, W: int, n_keyframe_rows: int,
                 n_recent_rows: int, device=None):
        self.H, self.W = H, W
        self.HW = H * W
        self.n_kf_rows = n_keyframe_rows
        self.n_recent_rows = n_recent_rows
        C = n_keyframe_rows + n_recent_rows
        self.capacity = C
        self._row_of_frame: Dict[int, int] = {}
        self._next_kf_row = 0
        self._next_recent = 0
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        kw = {"device": self.device}
        self.rgb = torch.zeros((C, self.HW, 3), dtype=torch.uint8, **kw)
        self.depth = torch.zeros((C, self.HW), dtype=torch.float16, **kw)
        self.normal = torch.zeros((C, self.HW, 3), dtype=torch.float16, **kw)
        self.gt_depth = torch.zeros((C, self.HW), dtype=torch.float16, **kw)
        self.mask = torch.zeros((C, self.HW), dtype=torch.bool, **kw)

    def __contains__(self, frame_id: int) -> bool:
        return frame_id in self._row_of_frame

    def row(self, frame_id: int) -> int:
        return self._row_of_frame[frame_id]

    def data(self) -> FrameData:
        return FrameData(self.rgb, self.depth, self.normal, self.gt_depth, self.mask)

    def put(self, frame_id: int, *, rgb: np.ndarray, depth: np.ndarray,
            normal: np.ndarray, gt_depth: Optional[np.ndarray],
            mask: Optional[np.ndarray], is_keyframe: bool) -> int:
        """Stage one frame. rgb [HW,3] float in [0,1] or uint8; depth [HW];
        normal [HW,3]; gt_depth [HW] or None; mask [HW] or None."""
        if frame_id in self._row_of_frame:
            return self._row_of_frame[frame_id]
        if is_keyframe:
            row = self._next_kf_row
            if row >= self.n_kf_rows:
                raise RuntimeError(
                    f"FrameStore keyframe rows exhausted staging frame "
                    f"{frame_id}: capacity {self.n_kf_rows} keyframe rows "
                    f"(+{self.n_recent_rows} recent); the runner sizes this as "
                    f"n_images // keyframe_every + 2 — check the conf's n_images")
            self._next_kf_row += 1
        else:
            row = self.n_kf_rows + (self._next_recent % self.n_recent_rows)
            self._next_recent += 1
            for fid, r in list(self._row_of_frame.items()):
                if r == row:
                    del self._row_of_frame[fid]
        self._row_of_frame[frame_id] = row

        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)

        def put_row(dst: torch.Tensor, src: np.ndarray):
            dst[row] = torch.from_numpy(np.ascontiguousarray(src)).to(self.device)

        put_row(self.rgb, rgb)
        put_row(self.depth, depth.astype(np.float16))
        put_row(self.normal, normal.astype(np.float16))
        put_row(self.gt_depth, (gt_depth if gt_depth is not None
                                else np.ones((self.HW,))).astype(np.float16))
        put_row(self.mask, (mask if mask is not None
                            else np.ones((self.HW,))).astype(np.bool_))
        return row
