"""Both packages end to end on the same scan, each evaluated by its own
battery, on the CPU: the port's quality against the JAX package's.

tools/eval_both_packages.py runs them: confs/replica/runconf_replica_2.conf
(colour top-k, warp loss, GT depth, BA, mapping every 5th frame) with the
tiny model widths of _torch_tiny, as tests/test_torch_frame0_fog.py builds
it, with the camera free-space guard on (``loss.cam_freespace_w = 1.0``,
as chip_smoke.py runs the flagship) and ``global_window_start = 10``; 11
frames of the synthetic scan at 48x64 (LPIPS's AlexNet needs 31 pixels
for an output after its second pool), 30 tracking and 30 mapping
iterations, 256 tracking and 512 mapping rays, mapping at frames 0, 5 and
10. Each package runs its CLI (``exp_runner``) with its own random
stream, then its own battery (the JAX package's tools/eval_checkpoint.py,
the port's ``evaluation.eval_checkpoint``) with the mesh at 48³ against
the analytic scene mesh.

Tolerance, on the mean over seeds 0 and 1 of each package: the port's ATE
RMSE <= max(1.5 x JAX, JAX + 0.01), its interpolate PSNR >= JAX - 1 dB,
its completion ratio >= JAX - 0.05. One seed is not enough at this size:
over seeds 0-3 (``tools/eval_both_packages.py --seeds 0 1 2 3``) the JAX
package's own ATE ranged 0.0146-0.0333, its completion ratio 0.019-0.117
and its PSNR 15.7-18.1 dB, so one JAX seed fails these bounds against
another JAX seed.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "eval_both_packages", os.path.join(REPO, "tools", "eval_both_packages.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{package: [battery results per seed]} from tools/eval_both_packages.py:
    the JAX package's runs one after the other in one process (the second
    loads the first one's compiled programs), the port's at once beside it,
    each on one torch thread."""
    return _tool().run(str(tmp_path_factory.mktemp("e2e")), SEEDS)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_each_battery_finishes(runs, pkg):
    """Every section of each run's battery holds finite numbers: eval_cam
    over all 11 frames, the mesh against the analytic scene, the depth
    bias at 5 probe frames, the interpolate view (frame 2)."""
    n_frames = _tool().N_FRAMES
    for res in runs[pkg]:
        assert "eval_rendering_error" not in res
        assert res["last_est_frame"] == n_frames - 1 and res["eval_cam"]["n_frames"] == n_frames
        assert res["eval_rendering_interpolate"]["n_views"] == 1
        assert len(res["depth_bias"]) == 5
        for k in ("eval_cam", "eval_rec", "eval_rendering_interpolate"):
            assert "error" not in res[k], (k, res[k])
            assert np.isfinite(list(res[k].values())).all(), (k, res[k])


def test_port_quality_within_tolerance_of_jax(runs):
    """The means over seeds 0 and 1: ATE RMSE, interpolate PSNR and
    completion ratio at 5 cm, held to the bounds of the module docstring."""
    s = _tool().summary(runs)
    print(json.dumps(s, indent=1))
    j, t = s["jax"]["mean"], s["port"]["mean"]
    assert t["ate"] <= max(1.5 * j["ate"], j["ate"] + 0.01), s
    assert t["psnr"] >= j["psnr"] - 1.0, s
    assert t["completion_ratio"] >= j["completion_ratio"] - 0.05, s
