"""Frame 0 of the flagship configuration on the synthetic scan, in the JAX
package and in the torch port, on the CPU.

Without the camera free-space guard (``loss.cam_freespace_w``, off in the
shipped conf) the frame-0 mapping call drives the SDF negative at the
camera and at every point of the mesh grid ("fog"): the vis hook then finds
no zero crossing and writes no mesh. With the guard at 1.0 the camera stays
outside the surface and the SDF keeps a zero crossing. Both packages do the
same, so this is a property of the configuration on this scan, not of the
port; chip_smoke.py runs the flagship conf with the guard on for it.

The conf is confs/replica/runconf_replica_2.conf with the tiny model widths
of _torch_tiny (colour top-6, geometric init on both SDF networks as in the
flagship), 24x32 frames, 256 mapping rays and 30 iterations. The two
packages part ways within a few iterations of the collapse (float32 sums in
other orders), so they are held to the same outcome, not value by value.
"""

import os

import numpy as np
import pytest
import torch

import _torch_tiny
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 24, 32


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    from nicer_slam_tpu_torch.datasets.synthetic import generate

    d = str(tmp_path_factory.mktemp("fog") / "Synthetic")
    generate(d, scan_id=2, n_frames=2, H=H, W=W, keyframe_every=10, with_flow=True)
    return d


def _conf(tmp_path, data_dir, guard: float) -> str:
    text = open(os.path.join(REPO, "confs", "replica", "runconf_replica_2.conf")).read()
    model = (_torch_tiny.MODEL_CONF
             .replace("use_warp_loss = true", "use_warp_loss = true\n    color_topk = 6")
             .replace("geometric_init = false", "geometric_init = true"))
    text = text[:text.index("\nmodel {")] + model
    edits = [('"../Datasets/processed/Replica"', f'"{data_dir}"'),
             ("680\n        1200", f"{H}\n        {W}"), ("n_images = 2000", "n_images = 1"),
             ("iters = 100", "iters = 30"), ("mapping_num_pixels = 8192",
                                             "mapping_num_pixels = 256")]
    if guard:
        edits.append(("    flow_weight = 0.001\n",
                      f"    flow_weight = 0.001\n    cam_freespace_w = {guard}\n"))
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    path = tmp_path / f"fog_{guard}.conf"
    path.write_text(text)
    return str(path)


def _grid():
    xs = np.linspace(-1, 1, 32, dtype=np.float32)
    return np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)


def _frame0(r, sdf):
    """(SDF at the camera, SDF on the mesh grid) before and after frame 0."""
    pts = np.concatenate([np.asarray(r.dataset.gt_pose_all[0][:3, 3], np.float32)[None],
                          _grid()])
    before = sdf(pts)
    r.track(0)
    r.map(0)
    after = sdf(pts)
    return [(s[0], s[1:]) for s in (before, after)]


def _frame0_jax(conf, root):
    import jax.numpy as jnp

    from nicer_slam_tpu.models import fields
    from nicer_slam_tpu.slam.runner import SLAMRunner

    r = SLAMRunner(conf=conf, root_dir=root, quiet=True)
    return _frame0(r, lambda x: np.asarray(fields.combine_sdf(
        r.scene_cfg.combine, r.params["implicit"], jnp.asarray(x), "fine")[:, 0]))


def _frame0_torch(conf, root):
    from nicer_slam_tpu_torch.models import fields
    from nicer_slam_tpu_torch.slam.runner import SLAMRunner

    r = SLAMRunner(conf=conf, root_dir=root, quiet=True, device="cpu")

    @torch.no_grad()
    def sdf(x):
        return fields.combine_sdf(r.model.implicit, torch.from_numpy(x), "fine")[:, 0].numpy()
    # one thread: the suite runs test files in parallel workers, and torch's
    # spinning thread pool in each of them starves the others
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _frame0(r, sdf)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("guard", [0.0, 1.0])
def test_frame0_fog_without_the_camera_guard_in_both_packages(scan, tmp_path, guard):
    """Before mapping, the camera is outside (SDF about +0.7) and the grid
    holds both signs. Without the guard both packages end frame 0 with the
    camera inside (SDF < 0) and no positive SDF on the 32³ grid; with it,
    both keep the camera outside and a zero crossing on the grid."""
    conf = _conf(tmp_path, scan, guard)
    for pkg, frame0 in (("jax", _frame0_jax), ("torch", _frame0_torch)):
        (cam0, grid0), (cam, grid) = frame0(conf, str(tmp_path / pkg))
        assert cam0 > 0.5 and grid0.min() < 0 < grid0.max(), (pkg, cam0)
        assert np.isfinite(grid).all(), pkg
        if guard:
            assert cam > 0 and grid.min() < 0 < grid.max(), (pkg, cam, grid.max())
        else:
            assert cam < 0 and grid.max() < 0, (pkg, cam, grid.max())
