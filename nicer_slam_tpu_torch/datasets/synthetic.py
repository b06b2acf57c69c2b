"""Synthetic VolSDF scans (counterpart of nicer_slam_tpu/datasets/synthetic.py).

The reference package's generator is numpy only; it is reused by import,
not copied. It writes its PNGs with ``imageio.v2.imwrite``; where imageio
is not installed, ``generate`` first registers a stand-in that writes
through OpenCV (RGB(A) -> BGR(A); 16-bit grayscale as is), which the port's
dataset loader reads back.
"""

from __future__ import annotations

import importlib.util
import sys
import types


def _imageio_through_opencv() -> None:
    if importlib.util.find_spec("imageio") is not None:
        return
    import cv2
    import numpy as np

    def imwrite(path, im):
        im = np.asarray(im)
        if im.ndim == 3:
            im = im[..., [2, 1, 0, 3][:im.shape[-1]]]
        if not cv2.imwrite(path, im):
            raise IOError(f"cannot write {path}")

    v2 = types.ModuleType("imageio.v2")
    v2.imwrite = imwrite
    mod = types.ModuleType("imageio")
    mod.v2 = v2
    sys.modules.setdefault("imageio", mod)
    sys.modules.setdefault("imageio.v2", v2)


def generate(out_dir: str, **kwargs) -> str:
    """Write a full VolSDF-layout scan (see the reference generator for the
    arguments); returns the data_dir to point a conf at."""
    _imageio_through_opencv()
    from nicer_slam_tpu.datasets.synthetic import generate as _generate

    return _generate(out_dir, **kwargs)
