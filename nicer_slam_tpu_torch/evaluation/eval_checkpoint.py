"""Run the full eval battery (eval_cam / eval_rec / eval_rendering) off an
existing run directory's LATEST checkpoint — no SLAM loop (counterpart of
the JAX package's tools/eval_checkpoint.py, with the same sections and
JSON keys).

The run may come from either package: the model and pose files are the
same (slam/checkpoint.py). The battery restores it through
``SLAMRunner(is_continue=True)`` on ``--device`` and renders and meshes
there (the port's kernels on the card); the interpolate-rendering
protocol and the mesh frame index are clamped to the last *estimated*
frame so a truncated trajectory is never evaluated against views it was
never shown. A section that raises is recorded as ``{"error": ...}`` (the
rendering sections as ``eval_rendering_error``) and the battery carries
on; ``failed_sections`` lists them.

Usage:
  python -m nicer_slam_tpu_torch.evaluation.eval_checkpoint \
      --rundir <.../<exps>/<exp>_<scan>/<ts>/> [--out OUT.json] \
      [--mesh_res 256] [--eval_data_dir <dir>_eval] [--n_eval_views 8] \
      [--synthetic_gt_mesh] [--device cuda|cpu]

``--out`` defaults to ``<rundir>/eval_checkpoint.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List


def failed_sections(results: dict) -> List[str]:
    """The sections of a battery's results that hold an error."""
    bad = [k for k, v in results.items() if isinstance(v, dict) and "error" in v]
    return bad + (["eval_rendering"] if "eval_rendering_error" in results else [])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rundir", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--mesh_res", type=int, default=256)
    ap.add_argument("--n_eval_views", type=int, default=8)
    ap.add_argument("--eval_data_dir", default=None,
                    help="held-out extrapolation scan dir (…_eval)")
    ap.add_argument("--synthetic_gt_mesh", action="store_true",
                    help="compare the mesh against the analytic synthetic "
                         "scene SDF (datasets/synthetic.py)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..slam.runner import SLAMRunner
    from .eval_cam import evaluate_run
    from .eval_rendering import evaluate_rendering

    # float32 convolutions and matmuls in full float32, as the reference
    # package's XLA ones
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rundir = os.path.abspath(args.rundir.rstrip("/"))
    timestamp = os.path.basename(rundir)
    exps_dir = os.path.dirname(os.path.dirname(rundir))
    root_dir = os.path.dirname(exps_dir)
    conf_path = os.path.join(rundir, "runconf.conf")
    out_path = args.out or os.path.join(rundir, "eval_checkpoint.json")

    results = {"rundir": rundir}

    def dump():
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)

    t0 = time.time()
    try:
        cam = evaluate_run(rundir, make_plot=True)
        results["eval_cam"] = {k: float(v) for k, v in cam.items()
                               if np.isscalar(v) and np.isfinite(v)}
        print(f"[eval_ckpt {time.time() - t0:.1f} s] eval_cam: ate_rmse={cam['ate_rmse']:.4f} "
              f"n={cam['n_frames']}", flush=True)
    except Exception as e:
        results["eval_cam"] = {"error": str(e)}
    dump()

    r = SLAMRunner(conf=conf_path, root_dir=root_dir,
                   exps_folder_name=os.path.basename(exps_dir), is_continue=True,
                   timestamp=timestamp, quiet=True, device=args.device)
    last = max(r.est_pose_all.keys())
    results["last_est_frame"] = int(last)
    print(f"[eval_ckpt {time.time() - t0:.1f} s] restored through frame {last}", flush=True)

    # --- mesh --------------------------------------------------------------
    try:
        from ..utils.plots import save_mesh
        from .eval_rec import calc_3d_metric

        est_ply = save_mesh(r, int(last), resolution=args.mesh_res)
        print(f"[eval_ckpt {time.time() - t0:.1f} s] mesh: {est_ply}", flush=True)
        if est_ply is not None and args.synthetic_gt_mesh:
            from ..datasets.synthetic import scene_sdf
            from ..ops.marching_cubes import extract_mesh
            from ..utils.ply import write_ply

            gt_mesh = extract_mesh(scene_sdf, resolution=args.mesh_res,
                                   grid_boundary=(-1.0, 1.0))
            if gt_mesh is not None:
                gv, gf, gn = gt_mesh
                gt_dir = os.path.join(rundir, "eval_rec")
                os.makedirs(gt_dir, exist_ok=True)
                gt_ply = os.path.join(gt_dir, "gt_mesh.ply")
                write_ply(gt_ply, gv, gf, normals=gn)
                rec = calc_3d_metric(est_ply, gt_ply, n_points=200000,
                                     do_icp=True)
                results["eval_rec"] = {k: float(v) for k, v in rec.items()}
                print(f"[eval_ckpt {time.time() - t0:.1f} s] eval_rec: {rec}", flush=True)
        results["est_mesh"] = est_ply
    except Exception as e:
        results["eval_rec"] = {"error": str(e)}
    dump()

    # --- rendered-depth scale bias ------------------------------------------
    # If the map's rendered depth at a frame's estimated pose is a
    # multiplicative factor k of the true depth, the photometric tracking
    # translation that re-aligns pixels scales by ~k — a per-frame step
    # inflation that integrates into Horn-scale drift. Median ratio per
    # probe frame; requires the dataset to ship *_gt_depth.png.
    try:
        if getattr(r.dataset, "gt_depth_paths", None):
            rows = []
            for f in sorted({0, int(last) // 4, int(last) // 2,
                             3 * int(last) // 4, int(last)}):
                rendered = r.render_full_image(f)["depth"].reshape(-1)
                gt_d = r.dataset.frame(f)["gt_depth"]
                ok = (gt_d > 1e-4) & np.isfinite(rendered) & (rendered > 1e-4)
                ratio = rendered[ok] / gt_d[ok]
                rows.append({"frame": int(f),
                             "depth_ratio_median": float(np.median(ratio)),
                             "depth_ratio_p25": float(np.percentile(ratio, 25)),
                             "depth_ratio_p75": float(np.percentile(ratio, 75)),
                             "depth_mae": float(np.mean(np.abs(
                                 rendered[ok] - gt_d[ok])))})
                print(f"[eval_ckpt {time.time() - t0:.1f} s] depth bias f{f}: "
                      f"median ratio {rows[-1]['depth_ratio_median']:.3f}",
                      flush=True)
            results["depth_bias"] = rows
    except Exception as e:
        results["depth_bias"] = {"error": str(e)}
    dump()

    # --- rendering ---------------------------------------------------------
    try:
        # clamp the interpolate protocol to frames the run actually saw
        r.n_images = int(last) + 1
        interp = evaluate_rendering(r, eval_method="interpolate")
        results["eval_rendering_interpolate"] = {
            k: float(v) for k, v in interp.items() if np.isscalar(v)
            and not isinstance(v, str)}
        print(f"[eval_ckpt {time.time() - t0:.1f} s] interp psnr={interp['psnr']:.2f}", flush=True)
        dump()
        if args.eval_data_dir and os.path.exists(args.eval_data_dir):
            from ..datasets.scene_dataset import SLAMDataset

            eval_ds = SLAMDataset(data_dir=args.eval_data_dir,
                                  img_res=[r.H, r.W], scan_id=r.scan_id,
                                  n_images=args.n_eval_views)
            extrap = evaluate_rendering(r, eval_method="extrapolate",
                                        eval_dataset=eval_ds)
            results["eval_rendering_extrapolate"] = {
                k: float(v) for k, v in extrap.items() if np.isscalar(v)
                and not isinstance(v, str)}
            print(f"[eval_ckpt {time.time() - t0:.1f} s] extrap psnr={extrap['psnr']:.2f}", flush=True)
    except Exception as e:
        results["eval_rendering_error"] = str(e)
    results["wall_s"] = round(time.time() - t0, 1)
    dump()
    print(json.dumps(results, indent=2), flush=True)
    return results


if __name__ == "__main__":
    main()
