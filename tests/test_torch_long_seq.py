"""The port's long-run evaluation (evaluation/long_seq_eval.py) on the CPU:
a few frames of the slow-motion synthetic scan at 48x64, its JSON held
against the keys of the JAX package's committed long-run records, and a
resume of the same run root.

The JAX tool itself is not run here: it points jax's compile cache at a
fixed path outside the checkout.
"""

import json
import os

from nicer_slam_tpu_torch.evaluation import long_seq_eval

from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 6
ARGS = ["--frames", str(FRAMES), "--H", "48", "--W", "64", "--rad_per_frame", "0.003",
        "--iters", "2", "--track_iters", "2", "--rays", "128", "--track_rays", "64",
        "--cache_res", "16", "--lr", "0.002", "--track_lr", "0.005", "--track_lr_step", "12",
        "--track_lr_gamma", "0.5", "--motion_prior_spring", "0.1", "--ba_trust_radius",
        "0.01", "--ba_trust_rot", "1.0", "--cam_freespace_w", "10.0",
        "--cam_freespace_margin", "0.05", "--ba", "--mef", "5", "--color_topk", "16",
        "--checkpoint_freq", "3", "--interim_every", "4", "--mesh_eval_frame", "4",
        "--mesh_res", "32", "--rec_points", "20000", "--n_eval_views", "1", "--device", "cpu"]


def _record(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def test_long_seq_writes_the_records_keys_and_resumes(tmp_path):
    """One run, then a resume of its root (one test: the run is the cost,
    and a module fixture would run again in each worker that takes a
    test of this file)."""
    root = str(tmp_path)
    res = long_seq_eval.main(ARGS + ["--root", root])
    with open(os.path.join(root, "long_seq_eval.json")) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    guarded = _record("LONG_SEQ_GUARDED_r05.json")
    valid = _record("LONG_SEQ_VALID_r05B.json")
    # the top-level keys of both records, eval_rec_at_<n> at this run's frame
    want = {k.replace("_at_250", "_at_4").replace("_at_150", "_at_4")
            for k in list(guarded) + list(valid)} - {"resumed_from_frame"}
    assert want <= set(res), want - set(res)
    assert [r["frame"] for r in res["interim"]] == [4]
    for rec in res["interim"]:
        assert set(guarded["interim"][0]) <= set(rec), set(guarded["interim"][0]) - set(rec)
    for sec in ("eval_cam", "eval_rec", "eval_rendering_interpolate",
                "eval_rendering_extrapolate"):
        assert set(valid[sec]) <= set(res[sec]), (sec, set(valid[sec]) - set(res[sec]))
    assert set(valid["eval_rec_at_150"]) <= set(res["eval_rec_at_4"])
    assert res["eval_rendering_extrapolate"]["n_views"] == 1
    assert 0.0 < res["interim"][-1]["ate_rmse"] < 0.5
    assert os.path.exists(os.path.join(root, "long_seq_eval_poses.npz"))

    # --resume_root: the last checkpoint is the one written after the last frame
    out = os.path.join(root, "resumed.json")
    res = long_seq_eval.main(ARGS + ["--resume_root", root, "--out", out])
    assert res["resumed_from_frame"] == FRAMES - 1
    assert res["interim"] == []
    assert res["eval_cam"]["ate_rmse"] > 0.0
    with open(out) as f:
        assert json.load(f)["resumed_from_frame"] == FRAMES - 1
