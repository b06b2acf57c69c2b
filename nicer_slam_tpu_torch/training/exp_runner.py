"""CLI entry point (counterpart of nicer_slam_tpu/training/exp_runner.py).

Usage:
  python -m nicer_slam_tpu_torch.training.exp_runner --conf confs/runconf_demo_1.conf \
      [--is_continue] [--timestamp latest] [--checkpoint latest] \
      [--scan_id N] [--expname suffix] [--exps_folder exps] [--new_expfolder] \
      [--device cuda]

Runs the SLAM loop (tracking, mapping with BA, checkpoints) on the given
device, a CUDA card by default, with the visualisation hook of
utils/plots.py: after the last frame (and inside every plot_freq-th
frame's mapping call) it renders the frame in full and writes
vis/{rendering,normal,depth,merge}_*.png and the colored mesh
vis/surface_<frame>.ply.
"""

from __future__ import annotations

import argparse


def main(argv=None, frame_hook=None):
    """Parse the CLI, run the SLAM loop with the vis hook, return the
    runner. ``frame_hook(runner, frame_idx)`` fires after each frame."""
    parser = argparse.ArgumentParser(description="nicer_slam_tpu_torch SLAM loop")
    parser.add_argument("--conf", type=str,
                        default="./confs/replica/runconf_replica_2.conf")
    parser.add_argument("--expname", type=str, default="")
    parser.add_argument("--exps_folder", type=str, default="exps")
    parser.add_argument("--is_continue", default=False, action="store_true",
                        help="continue from a previous run")
    parser.add_argument("--new_expfolder", default=False, action="store_true",
                        help="create a new run dir when continuing")
    parser.add_argument("--timestamp", default="latest", type=str,
                        help="run timestamp to continue from")
    parser.add_argument("--checkpoint", default="latest", type=str,
                        help="checkpoint name to continue from")
    parser.add_argument("--scan_id", type=int, default=-1,
                        help="overrides the conf's dataset.scan_id")
    parser.add_argument("--root_dir", type=str, default=".",
                        help="where the exps folder lives")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cpu runs the kernels' plain versions)")
    opt = parser.parse_args(argv)

    import torch

    from ..slam.runner import SLAMRunner
    from ..utils.plots import vis_hook

    # float32 matmuls in full float32, as the reference package's XLA ones
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runner = SLAMRunner(
        conf=opt.conf, expname=opt.expname, exps_folder_name=opt.exps_folder,
        is_continue=opt.is_continue, timestamp=opt.timestamp,
        new_expfolder=opt.new_expfolder, checkpoint=opt.checkpoint,
        scan_id=opt.scan_id, root_dir=opt.root_dir, seed=opt.seed,
        device=opt.device)
    runner.run(vis_hook=vis_hook, frame_hook=frame_hook)
    return runner


if __name__ == "__main__":
    main()
