"""Long-sequence evaluation on the slow-motion synthetic scan (counterpart
of tools/long_seq_eval.py, with its flags and JSON keys).

Generates a slow-motion synthetic scan (``--rad_per_frame 0.003``, the
Replica-at-2000-frames motion regime, closed-form ground truth) and its
held-out extrapolation views, runs the whole SLAM loop through
``SLAMRunner.run`` (tracking, mapping, BA, checkpoints) and then the eval
battery of the port's evaluation layer:

  * eval_cam       ATE / rotation / translation on the estimated
                   trajectory (sim3 prealign)
  * eval_rec       the mesh against the analytic scene mesh (accuracy,
                   completion, Chamfer, F-score, normal consistency)
  * eval_rendering PSNR / SSIM / LPIPS, interpolate and extrapolate

Every ``--interim_every`` frames the ATE of the trajectory so far, the
rotation drift and the map's health (the share of a 32³ grid with a
negative SDF, frame 0's PSNR) go into ``interim`` and the JSON is
rewritten, so a run that is cut still leaves a drift curve;
``--mesh_eval_frame`` runs the mesh battery once mid-run
(``eval_rec_at_<frame>``); ``--resume_root`` resumes a run root's latest
checkpoint.

Usage (the guarded command of the JAX package's record,
LONG_SEQ_GUARDED_r05.json):
  python -m nicer_slam_tpu_torch.evaluation.long_seq_eval \\
      --frames 250 --rad_per_frame 0.003 \\
      --iters 60 --track_iters 100 --rays 4096 --track_rays 1024 \\
      --lr 0.002 --track_lr 0.005 --track_lr_step 12 --track_lr_gamma 0.5 \\
      --motion_prior_spring 0.1 --ba_trust_radius 0.01 --ba_trust_rot 1.0 \\
      --cam_freespace_w 10.0 --cam_freespace_margin 0.05 \\
      --ba --mef 5 --color_topk 16 --checkpoint_freq 50 --interim_every 50 \\
      [--root DIR] [--out OUT.json] [--device cuda|cpu]

The run root is ``--root`` (default a new temporary directory); ``--out``
defaults to ``<root>/long_seq_eval.json``, and the trajectory snapshots
go beside it (``<out>_poses.npz``).
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from .probe_conf import build_argparser, conf_text


def _scalars(d: dict) -> dict:
    import numpy as np
    return {k: float(v) for k, v in d.items()
            if np.isscalar(v) and not isinstance(v, str) and np.isfinite(v)}


def main(argv=None) -> dict:
    p = build_argparser()
    p.add_argument("--out", default=None)
    p.add_argument("--root", default=None,
                   help="run root (the scan, the conf and exps/); default a new "
                        "temporary directory")
    p.add_argument("--mesh_res", type=int, default=256)
    p.add_argument("--n_eval_views", type=int, default=8)
    p.add_argument("--seed", type=int, default=0,
                   help="the runner's seed (its weights' init and its draws)")
    p.add_argument("--rec_points", type=int, default=200000,
                   help="points sampled on each mesh for the mesh battery")
    p.add_argument("--interim_every", type=int, default=100,
                   help="record the trajectory's ATE every N frames so a cut "
                        "run still leaves a drift curve")
    p.add_argument("--mesh_eval_frame", type=int, default=0,
                   help="if > 0, run the mesh battery once mid-run at this frame")
    p.add_argument("--resume_root", default=None,
                   help="an existing run root (long_seq.conf, Synthetic/, exps/): "
                        "resume its latest checkpoint; the model and schedule "
                        "are then its conf's, not the flags'")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    import numpy as np
    import torch

    from ..datasets.scene_dataset import SLAMDataset
    from ..datasets.synthetic import generate, generate_eval, scene_sdf
    from ..models import fields
    from ..ops.marching_cubes import extract_mesh
    from ..slam.runner import SLAMRunner
    from ..utils.plots import save_mesh
    from ..utils.ply import write_ply
    from . import ate as ate_mod
    from .eval_cam import evaluate_run
    from .eval_rec import calc_3d_metric
    from .eval_rendering import evaluate_rendering

    # float32 matmuls and convolutions in full float32, as XLA's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.resume_root:
        root = args.resume_root
        args.data_dir = os.path.join(root, "Synthetic")
    else:
        root = args.root or tempfile.mkdtemp(prefix="long_seq_")
        os.makedirs(root, exist_ok=True)
    out_path = args.out or os.path.join(root, "long_seq_eval.json")
    data_dir = args.data_dir or os.path.join(root, "Synthetic")
    if not args.data_dir:
        print(f"[long_seq] generating {args.frames} frames (rad/frame "
              f"{args.rad_per_frame}) -> {data_dir}", flush=True)
        generate(data_dir, scan_id=1, n_frames=args.frames, H=args.H, W=args.W,
                 world_scale=3.0, with_flow=True, rad_per_frame=args.rad_per_frame)
        generate_eval(data_dir, scan_id=1, n_views=args.n_eval_views, H=args.H,
                      W=args.W, world_scale=3.0)
    conf_path = os.path.join(root, "long_seq.conf")
    if not args.resume_root:
        with open(conf_path, "w") as f:
            f.write(conf_text(args, data_dir))

    results = {"frames": args.frames, "rad_per_frame": args.rad_per_frame,
               "iters": args.iters, "track_iters": args.track_iters,
               "rays": args.rays, "track_rays": args.track_rays,
               "conf_weight": args.conf_weight, "ba": args.ba,
               "color_topk": args.color_topk, "mef": args.mef, "seed": args.seed,
               "device": str(device), "interim": []}
    if str(device).startswith("cuda"):
        results["card"] = torch.cuda.get_device_name(torch.device(device))
    t0 = time.time()

    def dump():
        # atomic: a kill mid-write must not truncate the results
        with open(out_path + ".tmp", "w") as f:
            json.dump(results, f, indent=2)
        os.replace(out_path + ".tmp", out_path)

    snap_path = os.path.splitext(out_path)[0] + "_poses.npz"

    def run_eval_rec(runner, frame_idx, key):
        est_ply = save_mesh(runner, frame_idx, resolution=args.mesh_res)
        gt_mesh = extract_mesh(scene_sdf, resolution=args.mesh_res,
                               grid_boundary=(-1.0, 1.0))
        if est_ply is None or gt_mesh is None:
            raise RuntimeError("mesh extraction failed")
        gv, gf, gn = gt_mesh
        gt_ply = os.path.join(root, "gt_mesh.ply")
        if not os.path.exists(gt_ply):
            write_ply(gt_ply, gv, gf, normals=gn)
        rec = calc_3d_metric(est_ply, gt_ply, n_points=args.rec_points, do_icp=True)
        results[key] = {k: float(v) for k, v in rec.items()}
        print(f"[long_seq] {key}: {rec}", flush=True)

    xs = np.linspace(-0.98, 0.98, 32, dtype=np.float32)
    health_grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)

    def interim_hook(runner, frame_idx):
        if args.mesh_eval_frame and frame_idx == args.mesh_eval_frame:
            t_mesh = time.time()
            try:
                run_eval_rec(runner, frame_idx, f"eval_rec_at_{frame_idx}")
            except Exception as e:
                results[f"eval_rec_at_{frame_idx}"] = {"error": str(e)}
            results["mesh_eval_wall_s"] = round(time.time() - t_mesh, 1)
            dump()
        if frame_idx == 0 or frame_idx % args.interim_every:
            return
        keys = sorted(runner.est_pose_all.keys())
        est = np.stack([runner.est_pose_all[k] for k in keys]).astype(np.float64)
        gt = np.stack([np.asarray(runner.dataset.gt_pose_all[k])
                       for k in keys]).astype(np.float64)
        try:
            m = ate_mod.evaluate_ate(gt, est, with_scale=True)
            a34, _ = ate_mod.prealign_cameras(est, gt)
            m.update(ate_mod.camera_alignment_errors(a34, gt[:, :3, :4]))
            m.update(ate_mod.rotation_drift(gt, est))
        except Exception as e:  # interim metrics never end the run
            m = {"error": str(e)}
        rec = {"frame": int(frame_idx), "wall_s": round(time.time() - t0, 1)}
        rec.update(_scalars(m))
        # map health: a negative share in (0, 1) means a surface exists;
        # 0 or 1 means the map died
        try:
            with torch.no_grad():
                sdf = fields.combine_sdf(
                    runner.model.implicit,
                    torch.from_numpy(health_grid).to(runner.device), "fine")[:, 0]
            rec["sdf_negfrac"] = float((sdf < 0).float().mean())
            out0 = runner.render_full_image(0)
            gt0 = runner.dataset.frame(0)["rgb"].reshape(out0["rgb"].shape)
            mse = float(np.mean((out0["rgb"] - gt0) ** 2))
            rec["psnr_frame0"] = float(-10.0 * np.log10(max(mse, 1e-12)))
        except Exception as e:
            rec["map_health_error"] = str(e)
        results["interim"].append(rec)
        dump()
        np.savez(snap_path + ".tmp.npz", keys=np.asarray(keys),
                 est=est.astype(np.float32), gt=gt.astype(np.float32))
        os.replace(snap_path + ".tmp.npz", snap_path)
        print(f"[long_seq] interim@{frame_idx}: ate={rec.get('ate_rmse', float('nan')):.4f} "
              f"rot_drift={rec.get('rot_drift_deg', float('nan')):.1f}deg "
              f"({rec['wall_s'] / max(frame_idx, 1):.2f}s/frame)", flush=True)

    r = SLAMRunner(conf=conf_path, root_dir=root, quiet=False, seed=args.seed,
                   is_continue=bool(args.resume_root), device=device)
    if args.resume_root:
        results["resumed_from_frame"] = int(r.start_frame_idx)
    r.run(frame_hook=interim_hook)
    slam_wall = time.time() - t0
    n_run = max(args.frames - r.start_frame_idx, 1)
    print(f"[long_seq] SLAM done in {slam_wall:.0f}s ({slam_wall / n_run:.2f}s/frame)",
          flush=True)
    results["slam_wall_s"] = round(slam_wall, 1)
    results["s_per_frame"] = slam_wall / n_run
    results["phase_s"] = {k: v["total_s"] for k, v in r.timer.summary().items()}
    results["rundir"] = r.rundir
    dump()

    def attempt(name, fn):
        try:
            fn()
        except Exception as e:
            print(f"[long_seq] {name} failed: {e}", flush=True)
            results[name] = {"error": str(e)}
        dump()

    def eval_cam():
        cam = evaluate_run(r.rundir, make_plot=True)
        results["eval_cam"] = _scalars(cam)
        print(f"[long_seq] eval_cam: ate_rmse={cam['ate_rmse']:.4f}", flush=True)

    attempt("eval_cam", eval_cam)
    attempt("eval_rec", lambda: run_eval_rec(r, args.frames - 1, "eval_rec"))

    def eval_rendering():
        interp = evaluate_rendering(r, eval_method="interpolate")
        results["eval_rendering_interpolate"] = _scalars(interp)
        dump()
        eval_ds = SLAMDataset(data_dir=data_dir + "_eval", img_res=[args.H, args.W],
                              scan_id=1, n_images=args.n_eval_views)
        extrap = evaluate_rendering(r, eval_method="extrapolate", eval_dataset=eval_ds)
        results["eval_rendering_extrapolate"] = _scalars(extrap)
        print(f"[long_seq] rendering: interp psnr={interp['psnr']:.2f} "
              f"extrap psnr={extrap['psnr']:.2f}", flush=True)

    attempt("eval_rendering", eval_rendering)
    if r.device.type == "cuda":
        from ..ops import _cuda
        results["launches"] = _cuda.launch_counts()
        dump()
    print(json.dumps(results, indent=2), flush=True)
    return results


if __name__ == "__main__":
    main()
