"""The synthetic-scan probe configuration of the long-run evaluation: the
conf template and the flags that fill it (the port's own copy of
tools/convergence_probe.py's ``CONF_TEMPLATE`` and ``build_argparser``,
with the port's dataset class and a ``--device`` flag beside ``--cpu``).

Every flag's default is the reference behaviour; the long-run commands
of the record switch on the guards (trust radius, motion-prior spring,
tracking lr anneal, camera free-space hinge) by flag.
"""

from __future__ import annotations

import argparse

CONF_TEMPLATE = """
SLAM {{
    mapping {{
        mapping_window_size = {window}
        BA = {ba}
        BA_ratio = {ba_ratio}
        BA_end_ratio = {ba_end_ratio}
        BA_cam_lr = {ba_cam_lr}
        BA_trust_radius = {ba_trust_radius}
        BA_trust_rot_deg = {ba_trust_rot}
        pose_graph_propagate = {pose_graph}
        keyframe_every = 10
        global_window_start = {gws}
        mapping_every_frame = {mef}
        iters = {map_iters}
        conf_weight = {conf_weight}
        conf_floor = {conf_floor}
        conf_recency_kf = {conf_recency_kf}
        conf_residual_beta = {conf_residual_beta}
    }}
    tracking {{ gt_cam = {gt_cam}  lr = {track_lr}  iters = {track_iters}  Hedge = 0  Wedge = 0
                lr_step_size = {track_lr_step}  lr_gamma = {track_lr_gamma}
                rot_lr_scale = {rot_lr_scale}
                motion_prior_w = {motion_prior_w}
                motion_prior_rot_w = {motion_prior_rot_w}
                motion_prior_spring = {motion_prior_spring} }}
}}
train {{
    expname = "probe"
    folder_suffix = "probe"
    dataset_class = "nicer_slam_tpu_torch.datasets.scene_dataset.SLAMDataset"
    lr_factor_for_coarse_grid = {grid_lr_factor}
    lr_factor_for_fine_grid = {grid_lr_factor}
    lr_factor_for_color_grid = 5.0
    tracking_num_pixels = {track_rays}
    checkpoint_freq = {checkpoint_freq}
    plot_freq = 10000
    learning_rate = {lr}
    mapping_num_pixels = {rays}
    split_n_pixels = 4800
}}
plot {{ plot_nimgs = 1  resolution = 64  grid_boundary = [ -1.0 1.0 ] }}
loss {{
    assign_scale_shift_init = true
    assign_scale = 20.0
    warp_loss_weight = {warp_w}
    warp_loss_type = "l1"
    rgb_loss = "torch.nn.L1Loss"
    eikonal_weight = 0.1
    smooth_weight = 0.005
    depth_weight = 0.1
    normal_l1_weight = 0.05
    normal_cos_weight = 0.05
    flow_weight = 0.001
    cam_freespace_w = {cam_fs_w}
    cam_freespace_margin = {cam_fs_margin}
}}
tracking_loss {{
    rgb_loss = "torch.nn.L1Loss"
    eikonal_weight = 0  smooth_weight = 0  depth_weight = 0
    normal_l1_weight = 0  normal_cos_weight = 0
}}
dataset {{
    data_dir = "{data_dir}"
    img_res = [ {H} {W} ]
    scan_id = 1
    use_mask = false
    use_gt_depth = true
    n_images = {n_images}
}}
model {{
    feature_vector_size = 64
    scene_bounding_sphere = 1.0
    use_warp_loss = true
    mapping_patchsizes = [ 1 ]
    tracking_patchsizes = [ 1 ]
    sampling_method = "important"
    density_method = "{density}"
    implicit_network {{
        coarse {{
            d_in = 3  d_out = 1  dims = [ 64 ]
            geometric_init = true  bias = 0.9  skip_in = []
            weight_norm = true  multires = 6  inside_outside = true
            use_grid_feature = true
            base_size = 32  end_size = 32  logmap = 19
            num_levels = 4  level_dim = 8  divide_factor = 1.0
            embedding_method = "nerf"
        }}
        fine {{
            d_in = 3  d_out = 1  dims = [ 64 64 64 ]
            geometric_init = true  bias = 0.9  skip_in = []
            weight_norm = true  multires = 6  inside_outside = true
            use_grid_feature = true
            base_size = 32  end_size = 128  logmap = 19
            num_levels = 8  level_dim = 4  divide_factor = 1.0
            embedding_method = "nerf"
        }}
    }}
    rendering_network {{
        mode = "idr"  d_in = 9  d_out = 3  dims = [ 64 64 ]
        weight_norm = true  multires_view = 4
        per_image_code = false  use_grid_feature = {color_grid}
    }}
    color_topk = {color_topk}
    density {{ params_init {{ beta = 0.1 }}  beta_min = 0.0001
               beta_warmup_scale = {beta_warmup}  beta_warmup_iters = {beta_warmup_iters} }}
    gridpredefinedensity {{}}
    ray_sampler {{ near = 0.0  N_samples = 64  N_samples_eval = 256  N_samples_extra = 32  prepass_ray_chunk = 2048
                   prepass_mode = "{prepass}"  prepass_cache_res = {cache_res} }}
}}
"""



def conf_text(args, data_dir: str) -> str:
    """CONF_TEMPLATE filled from the parsed flags for a scan at
    ``data_dir``."""
    return CONF_TEMPLATE.format(
        data_dir=data_dir, H=args.H, W=args.W, n_images=args.frames,
        map_iters=args.iters, track_iters=args.track_iters,
        rays=args.rays, track_rays=args.track_rays, lr=args.lr,
        track_lr=args.track_lr, grid_lr_factor=args.grid_lr_factor,
        ba="true" if args.ba else "false", mef=args.mef,
        window=args.window, ba_ratio=args.ba_ratio,
        ba_end_ratio=args.ba_end_ratio, ba_cam_lr=args.ba_cam_lr,
        ba_trust_radius=args.ba_trust_radius,
        ba_trust_rot=args.ba_trust_rot,
        cam_fs_w=args.cam_freespace_w,
        cam_fs_margin=args.cam_freespace_margin,
        gws=args.gws,
        pose_graph="true" if args.pose_graph else "false",
        gt_cam="true" if args.gt_cam else "false", warp_w=args.warp_w,
        track_lr_step=args.track_lr_step, track_lr_gamma=args.track_lr_gamma,
        rot_lr_scale=args.rot_lr_scale,
        motion_prior_w=args.motion_prior_w,
        motion_prior_rot_w=args.motion_prior_rot_w,
        motion_prior_spring=args.motion_prior_spring,
        conf_weight="true" if args.conf_weight else "false",
        conf_floor=args.conf_floor, conf_recency_kf=args.conf_recency_kf,
        conf_residual_beta=args.conf_residual_beta,
        density=args.density, beta_warmup=args.beta_warmup,
        beta_warmup_iters=max(int(args.iters * 0.8), 1),
        prepass=args.prepass, cache_res=args.cache_res,
        color_grid="true" if args.color_grid else "false",
        color_topk=args.color_topk,
        checkpoint_freq=args.checkpoint_freq)


def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the kernels' plain versions)")
    p.add_argument("--frames", type=int, default=9)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--track_iters", type=int, default=50)
    p.add_argument("--rays", type=int, default=4096)
    p.add_argument("--track_rays", type=int, default=1024)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--track_lr", type=float, default=0.01)
    p.add_argument("--track_lr_step", type=int, default=50,
                   help="tracking StepLR step_size (reference: 50)")
    p.add_argument("--track_lr_gamma", type=float, default=0.95,
                   help="tracking StepLR gamma (reference: 0.95); e.g. "
                        "step 8 gamma 0.5 anneals the Adam jitter floor "
                        "for slow-motion sequences")
    p.add_argument("--rot_lr_scale", type=float, default=1.0,
                   help="per-dim lr scale on the quaternion dims "
                        "(1.0 = reference; <1 shrinks the rotation noise "
                        "floor independently of translation)")
    p.add_argument("--motion_prior_w", type=float, default=0.0,
                   help="constant-velocity motion-prior weight on the "
                        "translation dims (0 = reference behavior)")
    p.add_argument("--motion_prior_rot_w", type=float, default=0.0,
                   help="motion-prior weight on the quaternion dims")
    p.add_argument("--gws", type=int, default=200,
                   help="SLAM.mapping.global_window_start (reference: 200)."
                        " Lower it so short probes enter the global-window"
                        " regime where precomputed-flow edges are live")
    p.add_argument("--motion_prior_spring", type=float, default=0.0,
                   help="decoupled (AdamW-style) spring toward the "
                        "constant-velocity init, fraction pulled back "
                        "per tracking iter (0 = reference behavior)")
    p.add_argument("--grid_lr_factor", type=float, default=20.0)
    p.add_argument("--ba", action="store_true")
    p.add_argument("--mef", type=int, default=4)
    p.add_argument("--gt_cam", action="store_true")
    p.add_argument("--warp_w", type=float, default=0.5)
    p.add_argument("--H", type=int, default=120)
    p.add_argument("--W", type=int, default=160)
    p.add_argument("--density", type=str, default="volsdf_gridpredefined")
    p.add_argument("--beta_warmup", type=float, default=0.0)
    p.add_argument("--prepass", type=str, default="cached")
    p.add_argument("--cache_res", type=int, default=128)
    p.add_argument("--window", type=int, default=6,
                   help="mapping_window_size (reference demo: 15)")
    p.add_argument("--ba_ratio", type=float, default=0.7)
    p.add_argument("--ba_end_ratio", type=float, default=1.0)
    p.add_argument("--ba_cam_lr", type=float, default=0.001)
    p.add_argument("--ba_trust_radius", type=float, default=0.0,
                   help="lifetime BA displacement cap per keyframe "
                        "(scene units; 0 = off = reference behavior)")
    p.add_argument("--cam_freespace_w", type=float, default=0.0,
                   help="collapse-guard hinge weight on sdf(camera) "
                        "(0 = off = reference behavior)")
    p.add_argument("--cam_freespace_margin", type=float, default=0.05)
    p.add_argument("--ba_trust_rot", type=float, default=0.0,
                   help="lifetime BA rotation cap per keyframe "
                        "(degrees; 0 = off = reference behavior)")
    p.add_argument("--pose_graph", action="store_true",
                   help="propagate BA keyframe corrections to attached frames")
    p.add_argument("--color_grid", action="store_true",
                   help="enable the logmap-24 color hash grid (flagship-like)")
    p.add_argument("--color_topk", type=int, default=0,
                   help="top-K color-sample pruning (0 = exact reference path)")
    p.add_argument("--conf_weight", action="store_true",
                   help="confidence-weighted mapping (drift-loop damping)")
    p.add_argument("--conf_floor", type=float, default=0.3)
    p.add_argument("--conf_recency_kf", type=float, default=2.0)
    p.add_argument("--conf_residual_beta", type=float, default=0.0)
    p.add_argument("--data_dir", default=None,
                   help="reuse a previously generated scan dir")
    p.add_argument("--checkpoint_freq", type=int, default=10000,
                   help="save Model/Optimizer/Pose checkpoints every N "
                        "frames (long runs: 50-100 so truncation-safe)")
    p.add_argument("--rad_per_frame", type=float, default=0.03,
                   help="per-frame camera motion; 0.003 = Replica-at-2000-"
                        "frames regime (10x slower than the demo default)")
    return p

