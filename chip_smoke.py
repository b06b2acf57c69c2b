#!/usr/bin/env python3
"""Smoke run of nicer_slam_tpu_torch on one CUDA card.

  python3 chip_smoke.py

Phases, in the order of their numbers (any failure exits non-zero
without the final line); they run in that order except that phase 9's dry
runs run right after phase 3, while the scans are written; phase 8 and
then phase 9's sweep run in a child process beside phases 5b to 7; and
phase 10 runs in a background process beside phases 5b to 9. The times
of those phases (seconds, s/frame, ms per iteration) are therefore taken
on a card and host they share with other work: the report marks them
"contended", and they do not compare with a run of the phase alone. The
kernels' times (phase 3) and the demo and flagship runs (phases 4 and 5)
are taken with the card to themselves:
  1. card: require CUDA; print the card's name and power limit. Two
     synthetic scans start generating in the background (processes this
     script waits for): the demo scan (11 frames, 720x1280, flow) and the
     flagship scan (11 frames, 680x1200, flow and GT depth, and 2 held-out
     views for the extrapolation eval); and a raw Replica-layout capture of
     the scene for phase 8 (21 frames, 680x1200 JPEGs and depth PNGs,
     traj.txt, the analytic mesh).
  2. build: compile csrc/*.cu for sm_90a (one nvcc per source, in
     parallel; plain C interface).
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, with errors, tolerances, CUDA-event times of each launch
     alone (on preallocated operands; the K1/K2 backward's time includes
     its maxima pass and the sweep that converts and re-zeroes its
     fixed-point accumulator) and of the plain version, and the kernel's bound
     (the bytes it must move over the card's memory rate, or its
     operations over the float32 rate, whichever is larger): K1 and K2 at
     the flagship path's shapes on ray-ordered and on uniform points
     (802,816 SDF points through the fine and coarse grids; the full
     133M-entry colour grid at the 131,072 top-16 points and at the demo's
     4096 x 98) and at a tracking iteration's 100,352 ray-ordered points
     (the backward without a table gradient, as tracking runs it), K4's
     plain composite at the demo's 4096 x 98, a render chunk's 2580 x 98
     and 64 x 200, K7 at a flagship mapping
     iteration's 8192 x 98 samples (unordered, as earlier kernels were
     timed, and ray-ordered), a tracking iteration's 1024 x 98 and a
     density-cache chunk (the counter bit for bit), K4 with colour
     top-16 at its tracking and mapping rays (1024 and 8192 x 98; the
     weights pass also on surface-like densities, where ties at exact
     zeros decide the last picks; torch.topk timed beside it as the
     library's pick alone), K4 at small shapes that the paths do not give
     it (64 rays x 200 samples, top-40 and top-12), K3 on both SDF grids at a density-cache build
     chunk (131,072 grid points), the ray-ordered exact prepass of a
     2580-ray render chunk (1,651,200 points) and as many uniform points,
     K5 at 1024 (tracking), 4096 and 8192 (mapping) rays, K5 given
     densities at a render chunk and at the exact prepass of a tracking
     and a flagship mapping iteration (1024 and 8192 rays, jittered z, the
     true near and far, the extras drawn per chunk of 1024 rays: 1 and 8
     rows), and K6 (sdf_density) building the 128³ density cache and the
     exact prepass of a 2580-ray render chunk (1,651,200 points) and of a
     tracking and a mapping iteration (1024 and 8192 rays x 640 jittered
     z, 5,242,880 points at 8192; each one launch and no other kernel,
     within 2e-5 of the largest density, both versions also measured
     against float64; the times on record printed beside the shipped
     kernel's),
     K6's general kernel on the networks of GENERAL_NETS (grid and ray
     mode) and an 8 x 256 skip network (a render chunk), its concat
     variant at flagship widths (2580, 8192 and 1024 x 640, and a ragged
     1001 x 601: GENERAL_CASES), K1/K2 at the
     channel counts 1, 3, 5, 6, 7 (100,352 uniform points), K1, K2 and K3
     on grids beyond 32 levels or 8 channels (HASH_WIDE_CASES: 40 x 2,
     16 x 16, 8 x 12 at a tracking iteration's 100,352 ray-ordered points),
     K2's backward on bf16 rows (the sharded colour encode's, at the
     flagship's colour grid on 131,072 top-16 and 401,408 demo points: its
     table gradient the same over 3 launches and equal to K2's), K6 ray
     mode, K5 given and K4's composite on 2580 rays from a camera outside
     the cube, whose rays exit it behind the camera (far < near): which
     entries are finite must agree with the plain versions, and K9
     (tsdf.integrate: one 680x1200 frame into a 256³
     volume that already holds one, bit for bit). The plain versions of K1/K2 run once;
     the K1/K2 backward runs twice more and its table gradient must come
     out the same bit for bit, with its kept fixed-point accumulator and
     touched-row bitmap zero after every launch; at C 2, 4, 8 it must
     equal hash_table_grad_fixed_plain bit for bit. At the tracking shape
     on the three shipped grids (check_hash_fixed_state): two launches in a
     row on the same kept state with other points (the rows only the
     first touched read 0 after the second) and a launch with a NaN
     cotangent at one level (every row of that level NaN, the others bit
     for bit with the plain version).
  4. demo: the demo configuration (confs/runconf_demo_1.conf, every network
     at full width) through the port's exp_runner: tracking on every frame,
     mapping + BA at frames 0, 5 and 10, global_window_start = 10 (200 by
     default, which would need 200 frames) so the frame-10 mapping call has
     live flow edges (keyframes 0 <-> 10), and the vis hook at the end
     with plot.resolution 256 for the mesh (the conf's 512³ would hold a
     1.6 GB grid on the host for no more of a check).
  5. flagship: confs/replica/runconf_replica_2.conf (8192 mapping rays,
     100/100 iterations, colour top-16, warp loss, GT depth) the same way,
     with the JAX package's camera free-space guard on (see PATHS).
     Launch counters are reset just before and read just after each run.
  5b. options: the flagship conf with the JAX package's default exact
     prepass (prepass_mode = exact: K6 ray mode and K5 given in every
     tracking and mapping iteration, no density cache), warp patches
     [1 5] under the SSIM warp loss and model_exposure, the free-space
     guard as in phase 5, 6 frames (mapping + BA at 0 and 5) through
     exp_runner; then the demo networks in nerf mode (no colour grid)
     with per-image codes, 3 frames. It fails on non-finite poses or
     losses, a frame-5 warp loss of 0, K6 grid mode or K5's cached mode
     launched in the options loop, K6 ray or K5 given launches other than
     the loop's tracking plus mapping iterations, or frozen per-image codes
     that changed.
  5c. networks: TINY_CONF (the JAX package's end-to-end test conf, copied
     here) through exp_runner on a 9-frame 60x80 scan with the exact
     prepass (the general K6 only, no shipped K6), then 5 frames with the
     density cache (the general K6's grid mode builds it); the flagship
     conf with concat_coarse_feature and the exact prepass for 3 frames
     (K6-concat launches equal to the loop's tracking plus mapping
     iterations, finite poses and losses); that run's Adam state saved in
     the optax layout and loaded (bit for bit, and the next step on the
     same gradients bit for bit); training/pretrain.py for 50 steps on the
     flagship networks (K1 launched, the loss falls, the npz loads into a
     flagship runner) and training/train_mono_prior.py for 20 (finite,
     falling).
  5d. wide grids: the flagship conf with a 16-level x 16-channel coarse
     grid, a 40-level fine grid and a 40-level colour grid (2^22 rows a
     level) for 3 frames through exp_runner (the general K6); it fails on
     non-finite poses or losses, a grid of the run not wide, a path kernel
     never launched (K1/K2 forward and backward among them: every grid of
     the run is wide, so they launched only at wide shapes), or the shipped
     K6 launched.
  6. eval: the port's checkpoint battery (evaluation/eval_checkpoint.py,
     its CLI's main) on the flagship run's directory, on the card: eval_cam
     (ATE, rotation drift), the mesh at 256³ against the analytic scene
     mesh (accuracy, completion, completion ratio, normal consistency,
     F-score), the rendered-depth bias probe, PSNR / SSIM / LPIPS at the
     interpolated view 2 and the 2 extrapolated views. It fails if a
     section holds an error or a non-finite value, if K6, K5 given, K4's
     composite.fwd, K1 fwd or K2 fwd never launched in it, or if K3 did;
     then render_full_image(2, pose=its estimate) must equal
     render_full_image(2) bit for bit, and LPIPS on the card must agree
     with its CPU value on that view within 1e-4.
  7. repeat: the demo configuration twice more in this process, 6 frames
     each (mapping at frames 0 and 5), same seed and scan, through the
     runner's loop; every per-frame pose, every mapping call's loss terms
     and every final model and voxel tensor must be the same bit for bit.
  8. preprocess: the capture through the port's preprocessing entry points
     on the card: replica_2_volsdf.convert_scene with cues (the mono prior,
     mono_prior.npz; held against the same module on the CPU within 1e-5
     on one frame) and geometric flows, the converted scan's on-disk
     contract checked; extract_flows(rgb_only=True), the classical flow,
     over the same 6 keyframe pairs (end-point error against the geometric
     flow), and on a 170x300 crop of frames 0 and 10 held against the same
     function on the CPU within 1e-9 px; GMFlow and DPT (depth and normal) from seeded weights written
     with to_flat and read back through the extraction CLIs' --ckpt /
     --depth_ckpt / --normal_ckpt, on one pair and one frame; tsdf_fusion's
     CLI at 256³ over the 21 GT depths through K9 (21 launches), its mesh
     against the analytic scene mesh by calc_3d_metric without ICP; then
     the demo networks and schedule at 680x1200 on the converted scan for
     11 frames (global_window_start 10: the frame-10 mapping call reads the
     converter's 0 <-> 10 flow pair and the card-made cues). Per-stage
     seconds and each network's forward alone (CUDA events) are printed.
     It fails on a non-finite output, a broken contract, K9 not launched
     once per frame, the mono prior or the classical flow off the CPU by
     more than its bound, or a frame-10 flow loss of 0.
  9. parallel: parallel.dryrun at the flagship's full widths (8192 rays,
     its grids), 2 mapping iterations in the replicated, psum_bf16 and
     sharded modes, under NCCL at world size 1 and as two gloo ranks
     sharing the card, the latter held against the one-process step (the
     JAX package's multichip bounds, psum_bf16's all-reduced colour-grid
     gradient within 4e-2 of the largest, and sharded's loss within 4e-3
     and every first gradient within 4e-2 of the largest, its table gathered
     whole; parallel/dryrun.compare). The sharded mode must shard the colour
     grid at two ranks and launch the bf16-row backward there, and take the
     replicated path at one (sharded_tables 0); per mode it prints the bytes
     sent by purpose, the colour grid's persistent bytes per rank and each
     rank's peak device memory; then
     parallel.sweep on two scans with the demo networks, 6 frames each,
     both on the card at once, each scene's poses equal to its solo
     exp_runner run bit for bit.
  10. long run: evaluation.long_seq_eval with the settings of the JAX
     package's guarded long run (tools/r5f_queue.sh) for 50 frames at
     120x160 (mesh battery at 128³); it fails on a non-finite ATE, a cut
     run or a map with no surface, and prints frame 50's ATE beside the
     JAX record's 0.0041.
  11. report: per run, translation error against GT per frame, the loss
     terms of each mapping call's last iteration, launch counts, s/frame,
     ms per track and map iteration, the runner's phase times, peak memory;
     the final model checkpoint is read back and held against the model;
     vis/ must hold rendering_*.png and surface_*.ply. Then one JSON line
     with every kernel (launches by path: demo, flagship, options (both
     runs of phase 5b, vis hooks included), networks (phase 5c's runs and
     pretrain), eval, preprocess, which
     counts phase 8's steps and its SLAM run, wide (phase 5d), parallel
     (the dry runs' sharded steps over their ranks and the swept scenes'
     processes) and long_run), the
     nvidia-smi line, and the result line.

Float32 matmuls run without TF32 (set explicitly below). Runs repeat bit
for bit without any process-wide torch setting: every sum on the paths
has a fixed order (phase 6 checks it). Scratch data goes to build/smoke/
inside the checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SMOKE_DIR = os.path.join(ROOT, "build", "smoke")
N_FRAMES = 11
# the frame from which the mapping window is global and carries flow edges
GLOBAL_WINDOW_START = 10
# the two runs: conf, the scan's image size and scan id, the conf's dataset
# line, and the run's own conf edits (beside those of write_conf)
# the vis hook's mesh at 128³ in the phases beside phases 8-10 (write_conf
# sets 256³; the mesh is most of a vis call, and these phases are the
# smoke's longest lane)
VIS_MESH_128 = ("resolution = 256", "resolution = 128")
PATHS = {
    "demo": dict(conf=os.path.join(ROOT, "confs", "runconf_demo_1.conf"), H=720, W=1280,
                 scan_id=1, data_dir='"../Datasets/processed/Demo"', n_images=200,
                 edits=[]),
    # On the synthetic scan the flagship conf's frame-0 mapping call (100
    # iterations, the metric depth anchor at weight 10) drives the SDF
    # negative everywhere ("fog": the camera ends up inside the surface) in
    # the JAX package as in the port, and no mesh has a zero crossing
    # (tests/test_torch_frame0_fog.py). The JAX package's camera free-space
    # guard (loss.cam_freespace_w, off in the shipped confs) keeps the
    # camera outside the surface.
    "flagship": dict(conf=os.path.join(ROOT, "confs", "replica", "runconf_replica_2.conf"),
                     H=680, W=1200, scan_id=2, data_dir='"../Datasets/processed/Replica"',
                     n_images=2000, eval_views=2,
                     edits=[("    flow_weight = 0.001\n",
                             "    flow_weight = 0.001\n    cam_freespace_w = 1.0\n")]),
    # the options phase: the flagship with the JAX package's default exact
    # prepass (8192 mapping rays in 8 prepass chunks of 1024, each with its
    # own extra bins), warp patches 1 and 5 under the SSIM warp loss, and
    # exposure; the free-space guard as in the flagship run
    "options": dict(conf=os.path.join(ROOT, "confs", "replica", "runconf_replica_2.conf"),
                    H=680, W=1200, scan_id=2, data_dir='"../Datasets/processed/Replica"',
                    n_images=2000,
                    edits=[("    flow_weight = 0.001\n",
                            "    flow_weight = 0.001\n    cam_freespace_w = 1.0\n"),
                           ("prepass_mode = cached", "prepass_mode = exact"),
                           ("mapping_patchsizes = [\n        1\n    ]",
                            "mapping_patchsizes = [\n        1\n        5\n    ]"),
                           ('warp_loss_type = "l1"', 'warp_loss_type = "ssim"'),
                           ("per_image_code = false",
                            "per_image_code = false\n        model_exposure = true"),
                           VIS_MESH_128]),
    # the networks phase: the flagship with concat_coarse_feature (the fine
    # network reads the coarse network's feature rows) and the exact
    # prepass (the JAX package cannot cache it), the free-space guard as in
    # the flagship run
    "concat": dict(conf=os.path.join(ROOT, "confs", "replica", "runconf_replica_2.conf"),
                   H=680, W=1200, scan_id=2, data_dir='"../Datasets/processed/Replica"',
                   n_images=2000,
                   edits=[("    flow_weight = 0.001\n",
                           "    flow_weight = 0.001\n    cam_freespace_w = 1.0\n"),
                          ("prepass_mode = cached", "prepass_mode = exact"),
                          ("num_levels = 8\n            level_dim = 4\n",
                           "num_levels = 8\n            level_dim = 4\n"
                           "            concat_coarse_feature = true\n"),
                          VIS_MESH_128]),
    # the wide-grid phase: the flagship with grids beyond 32 levels or 8
    # channels (the coarse SDF grid 16 levels x 16 channels, the fine one
    # 40 levels x 2, the colour grid 40 levels at 2^22 rows a level; its
    # channels are 2 in both packages), the free-space guard as in the
    # flagship run; the non-shipped network runs the general K6
    "wide": dict(conf=os.path.join(ROOT, "confs", "replica", "runconf_replica_2.conf"),
                 H=680, W=1200, scan_id=2, data_dir='"../Datasets/processed/Replica"',
                 n_images=2000,
                 edits=[("    flow_weight = 0.001\n",
                         "    flow_weight = 0.001\n    cam_freespace_w = 1.0\n"),
                        ("num_levels = 4\n            level_dim = 8\n",
                         "num_levels = 16\n            level_dim = 16\n"),
                        ("num_levels = 8\n            level_dim = 4\n",
                         "num_levels = 40\n            level_dim = 2\n"),
                        ("per_image_code = false\n        use_grid_feature = true\n",
                         "per_image_code = false\n        use_grid_feature = true\n"
                         "        color_num_levels = 40\n        color_logmap = 22\n"),
                        # the vis hook's mesh at 128³ (256³ took 52 s of the
                        # phase's 105 s on these grids)
                        VIS_MESH_128]),
    # the limits phase: the demo configuration at its full width with
    # sampler counts past the kernels' old limits (1280 prepass samples,
    # 128 + 64 + 2 = 194 sorted and composited a ray)
    "limits": dict(conf=os.path.join(ROOT, "confs", "runconf_demo_1.conf"), H=720, W=1280,
                   scan_id=1, data_dir='"../Datasets/processed/Demo"', n_images=200,
                   edits=[("        N_samples = 64\n        N_samples_eval = 640\n"
                           "        N_samples_extra = 32\n",
                           "        N_samples = 128\n        N_samples_eval = 1280\n"
                           "        N_samples_extra = 64\n"),
                          VIS_MESH_128]),
    # then the demo networks with the nerf colour mode (no colour grid) and
    # per-image codes
    "nerf": dict(conf=os.path.join(ROOT, "confs", "runconf_demo_1.conf"), H=720, W=1280,
                 scan_id=1, data_dir='"../Datasets/processed/Demo"', n_images=200,
                 edits=[('mode = "idr"\n        d_in = 9', 'mode = "nerf"\n        d_in = 3'),
                        ("per_image_code = false\n        use_grid_feature = true",
                         "per_image_code = true\n        use_grid_feature = false"),
                        VIS_MESH_128]),
    # the preprocess phase's run: the demo networks and schedule at 680x1200
    # on the scan that the port's Replica converter wrote (data_dir is set to
    # the converter's output by write_conf)
    "preprocess": dict(conf=os.path.join(ROOT, "confs", "runconf_demo_1.conf"), H=680,
                       W=1200, scan_id=1, data_dir='"../Datasets/processed/Demo"',
                       n_images=200,
                       edits=[("img_res = [\n        720\n        1280\n    ]",
                               "img_res = [\n        680\n        1200\n    ]")]),
}
# the synthetic scans phase 1 writes in the background: the two SLAM scans
# and the raw Replica-layout capture of the preprocess phase
SCENES = ("demo", "flagship", "capture")
# the raw capture: frames, world scale (cube units x 3, as
# tests/test_preprocess_e2e.py), Replica's fixed camera (the converter's
# default intrinsics at 1200 x 680), the analytic mesh's resolution
CAPTURE_FRAMES = 21
CAPTURE_SCALE = 3.0
CAPTURE_SCENE = "synthroom"
REPLICA_K = (600.0, 600.0, 599.5, 339.5)
CAPTURE_MESH_RES = 128
# the TSDF fusion of the capture's GT depth (and K9's check in phase 3), and
# the points sampled on each mesh for calc_3d_metric
TSDF_RES = 256
TSDF_EVAL_POINTS = 50_000
# the mono prior on the card against the same module on the CPU, one frame
MONO_PRIOR_ATOL = 1e-5
# the classical flow (float64) on the card against the CPU, on a crop of
# one keyframe pair (the CPU test's bound against the JAX package's numpy)
CLASSICAL_CROP = (170, 300)
CLASSICAL_ATOL = 1e-9
# plot.resolution of the vis hook's mesh in both runs (the confs' 512³
# holds a 1.6 GB grid on the host for no more of a check)
MESH_RESOLUTION = 256
# kernels whose launches are checked on each run (every launch counter is
# reported for both)
# (K3's work on the paths runs inside sdf_density; the standalone K3 kernel
# is still held against its plain version in phase 3)
# (K6 counts its grid mode, the cache builds, and its ray mode, the exact
# prepass, apart)
PATH_KERNELS = {
    "demo": ("hash_encode_with_grad.fwd", "hash_encode_with_grad.bwd", "hash_encode.fwd",
             "hash_encode.bwd", "sdf_density.grid", "sdf_density.rays", "composite.fwd",
             "composite.bwd", "importance_sample", "importance_sample_given",
             "voxels.scatter", "voxels.beta"),
    "flagship": ("hash_encode_with_grad.fwd", "hash_encode_with_grad.bwd", "hash_encode.fwd",
                 "hash_encode.bwd", "sdf_density.grid", "sdf_density.rays", "weights_topk.fwd",
                 "weights_topk.bwd", "topk_rgb.fwd", "topk_rgb.bwd", "importance_sample",
                 "importance_sample_given", "voxels.scatter", "voxels.beta"),
}
PATH_KERNELS["preprocess"] = PATH_KERNELS["demo"] + ("tsdf.integrate",)
# the options run's loop (before its vis hook): the exact prepass in every
# tracking and mapping iteration, no cache; K4's plain composite runs in
# the vis render only (the loop colours the top-16)
PATH_KERNELS["options"] = tuple(k for k in PATH_KERNELS["flagship"]
                                if k not in ("sdf_density.grid", "importance_sample"))
# the wide-grid run: the flagship's kernels, K6's general variant in place
# of the shipped one (cache builds and the vis render), and the wide grid
# shapes through K1 (coarse 16 x 16, fine 40 x 2) and K2 (colour 40 x 2),
# forward and backward
PATH_KERNELS["wide"] = tuple(
    {"sdf_density.grid": "sdf_density_general.grid",
     "sdf_density.rays": "sdf_density_general.rays"}.get(k, k)
    for k in PATH_KERNELS["flagship"])
WIDE_FRAMES = 3
# the limits run's frames (mapping at 0 and 5) and the kernels it must
# launch: the demo's, at the wider sampler counts
LIMITS_FRAMES = 6
PATH_KERNELS["limits"] = PATH_KERNELS["demo"]
# the options phase: frames of the flagship options run (mapping + BA at 0
# and 5) and of the nerf run (mapping at 0)
OPTIONS_FRAMES = 6
NERF_FRAMES = 3
# the networks phase: frames of the flagship concat run (mapping + BA at 0)
CONCAT_FRAMES = 3
# the JAX package's end-to-end test configuration (tests/test_slam_e2e.py
# TINY_CONF, copied; its dataset class written as the port names it): coarse
# [32] on a 2 x 4 grid, fine [32 32] on a 4 x 2 grid, the exact prepass (no
# prepass_mode), on a 60 x 80 synthetic scan of TINY_FRAMES frames
TINY_CONF = """
SLAM {{
    mapping {{
        mapping_window_size = 6
        BA = true
        BA_ratio = 0.7
        BA_cam_lr = 0.001
        keyframe_every = 10
        mapping_every_frame = 4
        iters = {map_iters}
    }}
    tracking {{ gt_cam = false  lr = 0.01  iters = {track_iters}  Hedge = 0  Wedge = 0
                lr_step_size = 4  lr_gamma = 0.5 }}
}}
train {{
    expname = "tiny"
    folder_suffix = "test"
    dataset_class = "datasets.scene_dataset.SLAMDataset"
    lr_factor_for_coarse_grid = 20.0
    lr_factor_for_fine_grid = 20.0
    lr_factor_for_color_grid = 5.0
    tracking_num_pixels = 192
    checkpoint_freq = 8
    plot_freq = 1000
    learning_rate = 0.002
    mapping_num_pixels = 512
    split_n_pixels = 2048
}}
plot {{ plot_nimgs = 1  resolution = 64  grid_boundary = [ -1.0 1.0 ] }}
loss {{
    assign_scale_shift_init = true
    assign_scale = 20.0
    warp_loss_weight = 0.5
    warp_loss_type = "l1"
    rgb_loss = "torch.nn.L1Loss"
    eikonal_weight = 0.1
    smooth_weight = 0.005
    depth_weight = 0.1
    normal_l1_weight = 0.05
    normal_cos_weight = 0.05
    flow_weight = 0.001
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
    feature_vector_size = 16
    scene_bounding_sphere = 1.0
    use_warp_loss = true
    mapping_patchsizes = [ 1 ]
    tracking_patchsizes = [ 1 ]
    sampling_method = "important"
    density_method = "volsdf_gridpredefined"
    implicit_network {{
        coarse {{
            d_in = 3  d_out = 1  dims = [ 32 ]
            geometric_init = true  bias = 0.9  skip_in = []
            weight_norm = true  multires = 6  inside_outside = true
            use_grid_feature = true
            base_size = 16  end_size = 16  logmap = 15
            num_levels = 2  level_dim = 4  divide_factor = 1.0
            embedding_method = "nerf"
        }}
        fine {{
            d_in = 3  d_out = 1  dims = [ 32 32 ]
            geometric_init = false  bias = 0.9  skip_in = []
            weight_norm = true  multires = 6  inside_outside = true
            use_grid_feature = true
            base_size = 16  end_size = 64  logmap = 17
            num_levels = 4  level_dim = 2  divide_factor = 1.0
            embedding_method = "nerf"
        }}
    }}
    rendering_network {{
        mode = "idr"  d_in = 9  d_out = 3  dims = [ 32 32 ]
        weight_norm = true  multires_view = 4
        per_image_code = false  use_grid_feature = false
    }}
    density {{ params_init {{ beta = 0.1 }}  beta_min = 0.0001 }}
    gridpredefinedensity {{}}
    ray_sampler {{ near = 0.0  N_samples = 24  N_samples_eval = 96  N_samples_extra = 8 }}
}}
"""
TINY_FRAMES, TINY_H, TINY_W, TINY_ITERS = 9, 60, 80, 12
# then TINY_CONF with a 20-layer fine network (19 hidden layers of 8 units:
# past the general kernel's old 16 layers), frame 0's mapping and frame 1's
# tracking
TINY_DEEP_FRAMES = 2
TINY_DEEP_FINE = "d_in = 3  d_out = 1  dims = [ " + " ".join(["8"] * 19) + " ]"
# then with prepass_mode = cached (mapping at 0 and 4)
TINY_CACHED_FRAMES = 5
# the training tools: pretrain's steps on the flagship networks (its
# default 32,768 uniform points a step), train_mono_prior's steps on a few
# procedural scenes at its default 96 x 128; the loss must fall from the
# mean of the first TOOL_WINDOW steps to that of the last
PRETRAIN_STEPS = 50
MONO_STEPS, MONO_SCENES, MONO_FRAMES = 20, 2, 4
TOOL_WINDOW = 5
# kernels that the evaluation phase must launch (the eval renders: K6's
# exact prepass, K5 given densities, K4's plain composite, K1's forward for
# the normals and the mesh, K2's forward for the colours), and K3, which it
# must not
EVAL_KERNELS = ("sdf_density.rays", "importance_sample_given", "composite.fwd",
                "hash_encode_with_grad.fwd", "hash_encode.fwd")
# LPIPS on the card against its CPU value on the same view (float32
# convolutions in other orders, no TF32)
LPIPS_ATOL = 1e-4
# (tolerance) values: max|kernel - plain| <= VAL_RTOL * max|plain|, per
# output; gradients written with float atomics (order changes from run to
# run): ||kernel - plain||_2 <= GRAD_REL_L2 * ||plain||_2
VAL_RTOL = 1e-5
GRAD_REL_L2 = 1e-5
# K6 (sdf_density): max|kernel - plain| <= SDF_DENSITY_RTOL * max|plain|,
# the CPU parity test's bound: the Laplace density's slope at the surface,
# 1/(2 beta^2), is ~35 times its largest value 1/beta (beta ~ 0.0144 at a
# zero count), so a few ulp of SDF rounding in either version's float32
# sums show as ~1e-5 of the largest density
SDF_DENSITY_RTOL = 2e-5
# importance sampler: every ray's z_vals and z_eik within Z_ATOL (float32
# scans in another order move a sample by a few ulps of z <= 3.5)
Z_ATOL = 1e-4
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM3
# rate and float32 outside the tensor cores, for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# ~1 ms of device clock cycles: longer than any wrapper's host time
SLEEP_CYCLES = 2_000_000


# what each overlapped phase shared the card and host with: its times are
# contended and do not compare with a run of the phase alone
CONTENDED = {
    "dryrun": "contended: the host wrote the scans beside them",
    "5b-7": "contended: phases 8, 9's sweep and 10 ran beside it",
    "8-9": "contended: phases 5b to 7 and 10 ran beside it",
    "10": "contended: phases 5b to 9 ran beside it",
}


def log(*a):
    print(*a, flush=True)


# the smoke's start, for the phase headers' elapsed times
_START = time.perf_counter()


def log_phase(msg: str):
    """A phase's header, with the seconds since the smoke started."""
    log(f"{msg} [t+{time.perf_counter() - _START:.0f} s]")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_time(fn, iters=10, warmup=2, before=None):
    """Mean CUDA-event time of ``fn`` in ms, each launch timed alone on the
    device: a sleep kernel queued ahead of the start event keeps the card
    busy while the host runs the wrapper and enqueues the launch, so the
    host's time does not count; ``before`` (e.g. zeroing a gradient table)
    runs outside the timed window."""
    import torch
    for _ in range(warmup):
        if before is not None:
            before()
        fn()
    marks = []
    for _ in range(iters):
        if before is not None:
            before()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def timed_once(fn):
    """(fn(), its CUDA-event time in ms): the plain versions at the path's
    shapes run once."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def rel_l2(a, b) -> float:
    return float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bytes_: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the float32 rate."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Checks:
    """Kernel results by name, and the names that failed."""

    def __init__(self):
        self.results, self.failures = {}, []

    def record(self, name, source, replaces, err, ok, ms, plain_ms, bytes_, ops,
               extra="", library_ms=None):
        bound_ms, bound_by = bound(bytes_, ops)
        self.results[name] = {"name": name, "route": "cuda", "source": source,
                              "replaces": replaces, "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": library_ms,
                              "share_of_bound": bound_ms / ms, "bytes": bytes_, "ops": ops}
        lib = "" if library_ms is None else f" library {library_ms:.3f} ms"
        log(f"  {name:38s} max_abs_err {err:.3e} {extra} kernel {ms:.3f} ms plain "
            f"{plain_ms:.3f} ms{lib} bound {bound_ms:.4f} ms ({bound_by}, "
            f"{bytes_ / 1e6:.1f} MB, {ops / 1e9:.2f} Gop) share {bound_ms / ms:.1%} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(name)

    def values(self, name, source, replaces, kern_outs, plain_outs, ms, pms, labels,
               bytes_, ops, library_ms=None):
        """Per output: max|kernel - plain| <= VAL_RTOL * max|plain|."""
        errs = [max_abs(a, b) for a, b in zip(kern_outs, plain_outs)]
        scales = [float(b.abs().max()) for b in plain_outs]
        self.record(name, source, replaces, max(errs),
                    all(e <= VAL_RTOL * s for e, s in zip(errs, scales)), ms, pms,
                    bytes_, ops,
                    "(" + ", ".join(f"{n} {e:.2e} of {s:.2e}" for n, e, s
                                    in zip(labels, errs, scales)) + ")", library_ms)


def _sampler_rays(g, dev, R):
    """R rays from (0, 0, -0.9) into a cone along +z, unit directions."""
    import torch
    ang = torch.rand((R, 2), generator=g, device=dev)
    o = torch.stack([torch.zeros(R, device=dev), torch.zeros(R, device=dev),
                     torch.full((R,), -0.9, device=dev)], -1)
    d = torch.stack([ang[:, 0] - 0.5, ang[:, 1] - 0.5, torch.ones(R, device=dev)], -1)
    return o, d / d.norm(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def ray_points(g, dev, R, S, surface_spread=None):
    """R rays x S points, ray-major and sorted along each ray, as the path
    hands them to the hash grids: z uniform in [0.05, 1.85] (the mapping
    samples), or within about ±3·surface_spread of a surface depth per ray
    (the colour top-k samples, which crowd at the surface)."""
    import torch
    o, d = _sampler_rays(g, dev, R)
    if surface_spread is None:
        z = torch.rand((R, S), generator=g, device=dev) * 1.8 + 0.05
    else:
        z = (0.9 + 0.3 * torch.rand((R, 1), generator=g, device=dev)
             + surface_spread * torch.randn((R, S), generator=g, device=dev))
    z = torch.sort(z, dim=1)[0]
    return (o[:, None, :] + z[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()


def uniform_points(g, dev, n):
    """n points uniform in [-1.05, 1.05]^3 (some outside: zero features)."""
    import torch
    return (torch.rand((n, 3), generator=g, device=dev) * 2.1 - 1.05).contiguous()


def touched_rows(spec, x) -> int:
    """Distinct table rows that the in-range points of x read, all levels:
    the table bytes a hash kernel must move for these inputs."""
    return int(touched_mask(spec, x).sum())


def touched_mask(spec, x):
    """[T] bool: the table rows that the in-range points of x read."""
    import torch
    from nicer_slam_tpu_torch.ops import hash_encoder as he
    u = (x + 1.0) / 2.0
    u = u[((u >= 0) & (u <= 1)).all(-1)]
    bits = torch.tensor(he._CORNER_BITS, dtype=torch.int64, device=x.device)
    mark = torch.zeros(spec.total_entries, dtype=torch.bool, device=x.device)
    for lvl in range(spec.num_levels):
        left = torch.floor(u * spec.scales[lvl]).to(torch.int64)
        mark[he._level_rows(spec, lvl, left[None] + bits[:, None, :]).reshape(-1)] = True
    return mark


def hash_cost(spec, n, rows, jac, bwd, table_grad=True):
    """(bytes, operations) of one K1/K2 launch over n points that touch
    ``rows`` table rows: each input read once, each output written once
    (the table rows read, and in the backward with ``table_grad`` their
    gradient written); operations are 2 per multiply-add of the corner
    sums (the backward's grad_x half of them without the table gradient)."""
    L, C = spec.num_levels, spec.level_dim
    per_pt = 3 + L * C * (1 + 3 * jac)           # x and feats (+ dfeat)
    table = rows * C
    if bwd:                                       # + g_x; table read, g_table written
        words = n * (per_pt + 3) + (2 if table_grad else 1) * table
        madds = C * (1 + 3 * jac) * (4 if table_grad else 2)
    else:
        words, madds = n * per_pt + table, C * (1 + 3 * jac)
    return 4 * words, 2 * madds * 8 * L * n


def hash_floor_ms(spec, n, rows, jac) -> float:
    """The least time of a K1/K2 backward with a table gradient as the
    port must run it, beside hash_cost's bound: that bound's bytes, plus
    the maxima pass's second read of the cotangents (the fixed-point
    exponents need them before the first atomic) and the untouched rows of
    the dense g_table written (the optimizer reads it whole), at the
    memory rate."""
    L, C = spec.num_levels, spec.level_dim
    nb, _ = hash_cost(spec, n, rows, jac, True)
    extra = 4 * n * L * C * (1 + 3 * jac) + 4 * (spec.total_entries - rows) * C
    return (nb + extra) / HBM_BYTES_PER_S * 1e3


# (grid, kernel, points): the SDF grids through K1 at the flagship's 8192
# mapping rays x 98 samples, the colour grid through K2 at its top-16
# samples and at the demo's 4096 x 98; each on ray-ordered and on uniform
# points
HASH_CASES = (("fine", True, "sdf"), ("coarse", True, "sdf"),
              ("color", False, "top16"), ("color", False, "demo"))


def hash_points(g, dev, kind, order):
    R, S, spread = {"sdf": (8192, 98, None), "top16": (8192, 16, 0.02),
                    "demo": (4096, 98, None)}[kind]
    return (ray_points(g, dev, R, S, spread) if order == "ray"
            else uniform_points(g, dev, R * S))


def check_hash_kernels(dev, chk: Checks):
    """K1 (fine, coarse) and K2 (color) forward and backward at the path's
    shapes, on ray-ordered and on uniform points, each launch timed alone
    on preallocated operands; the plain versions run once."""
    import torch

    specs = hash_specs()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for grid, jac, kind in HASH_CASES:
        spec = specs[grid]
        table = torch.rand((spec.total_entries, spec.level_dim), generator=g,
                           device=dev) * 2 - 1
        for order in ("ray", "uniform"):
            check_hash_case(dev, chk, g, spec, table, jac, hash_points(g, dev, kind, order),
                            f"[{grid}/{kind}/{order}]")
        del table
        torch.cuda.empty_cache()


def check_hash_case(dev, chk: Checks, g, spec, table, jac: bool, x, tag: str):
    """One K1 (jac) or K2 case: the forward against the plain version, the
    backward with the table gradient against autograd of the plain version,
    the same table gradient over 3 launches and the kept accumulator zero
    after each."""
    import torch
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    src = "nicer_slam_tpu_torch/csrc/hash_encoder.cu"
    L, C = spec.num_levels, spec.level_dim
    N = x.shape[0]
    rows = touched_rows(spec, x)
    kname = "hash_encode_with_grad" if jac else "hash_encode"
    replaces = "nicer_slam_tpu/ops/hash_encoder.py:" + ("266" if jac else "177")
    feats = torch.empty((N, L * C), device=dev)
    dfeat = torch.empty((N, L * C, 3), device=dev) if jac else None

    def fwd():
        he.hash_encode_fwd_launch(spec, table, x, 1.0, feats, dfeat)

    fwd()
    po, pms = timed_once(lambda: he.hash_encode_plain(spec, table, x, 1.0, jac))
    po = list(po) if jac else [po]
    chk.values(f"{kname}.fwd{tag}", src, replaces,
               [feats, dfeat] if jac else [feats], po, cuda_time(fwd), pms,
               ("feats", "dfeat"), *hash_cost(spec, N, rows, jac, False))
    del po
    # backward: the table gradient (mapping) and the input gradient
    gf = torch.randn((N, L * C), generator=g, device=dev)
    gd = torch.randn((N, L * C, 3), generator=g, device=dev) if jac else None
    g_table = torch.empty_like(table)
    g_x = torch.empty((N, 3), device=dev)

    def bwd():
        he.hash_encode_bwd_launch(spec, table, x, 1.0, jac, gf, gd, g_table, g_x)

    # the fixed-point state that the wrapper keeps: its accumulator and
    # touched-row bitmap must be zero after every launch
    scratch = he.fixed_point_scratch(spec, dev)
    zero_after = []
    bwd()
    zero_after.append(he.fixed_point_state_is_zero(spec, scratch))
    # the merge kernel's channel counts: bit for bit with its plain version
    exact = (bool(torch.equal(g_table, he.hash_table_grad_fixed_plain(spec, x, gf, gd)))
             if C in MERGE_CHANNELS else None)
    xx, tt = x.clone().requires_grad_(True), table.clone().requires_grad_(True)

    def plain_bwd():
        out = he.hash_encode_plain(spec, tt, xx, 1.0, jac)
        loss = (out[0] * gf).sum() + (out[1] * gd).sum() if jac else (out * gf).sum()
        return torch.autograd.grad(loss, [xx, tt])

    (pgx, pgt), pms = timed_once(plain_bwd)
    ex, et = rel_l2(g_x, pgx), rel_l2(g_table, pgt)
    err = max(max_abs(g_x, pgx), max_abs(g_table, pgt))
    # the table gradient is summed in fixed point: run to run the same
    first = g_table.clone()
    same = True
    for _ in range(2):
        bwd()
        zero_after.append(he.fixed_point_state_is_zero(spec, scratch))
        same &= torch.equal(first, g_table)
    del first
    ms = cuda_time(bwd)
    zero_after.append(he.fixed_point_state_is_zero(spec, scratch))
    chk.record(f"{kname}.bwd{tag}", src,
               replaces if jac else "nicer_slam_tpu/ops/hash_encoder.py:613",
               err, ex <= GRAD_REL_L2 and et <= GRAD_REL_L2 and same and exact is not False
               and all(zero_after), ms, pms,
               *hash_cost(spec, N, rows, jac, True),
               f"(rel L2: grad_x {ex:.2e}, grad_table {et:.2e}; {N} points, "
               f"{rows} rows; the same over 3 launches: {same}; bit for bit with "
               f"hash_table_grad_fixed_plain: {exact}; accumulator and bitmap zero after "
               f"each of 3 launches and after the timed ones: {zero_after}; floor with "
               f"the maxima pass and the dense g_table {hash_floor_ms(spec, N, rows, jac):.4f} "
               f"ms)")
    del xx, tt, pgx, pgt, g_table, g_x, gf, gd, feats, dfeat, scratch
    torch.cuda.empty_cache()


# the channel counts of the merge kernel (csrc/hash_kernels.cuh
# hash_bwd_merge_kernel), whose table gradient hash_table_grad_fixed_plain
# reproduces bit for bit; the others keep the lane-merge kernel
MERGE_CHANNELS = (2, 4, 8)


# the level given a NaN cotangent in the non-finite case below
NAN_LEVEL = 1


def check_hash_fixed_state(dev, chk: Checks):
    """What a backward that converts the touched rows alone could get
    wrong, at the tracking shape (1024 x 98 ray-ordered points) on the
    three shipped grids (the colour grid marks its touched rows; the SDF
    grids sweep every row): two launches in a row on the same kept state
    with other points (the second one's table gradient its own: the rows
    that only the first touched read 0), and a launch with a NaN cotangent
    at one level (every row of that level NaN, the other levels as the
    plain version); each bit for bit with hash_table_grad_fixed_plain and
    within GRAD_REL_L2 of autograd of the plain encode, the accumulator and
    bitmap zero after every launch. Each case's launch is timed."""
    import torch
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    specs = hash_specs()
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    src = "nicer_slam_tpu_torch/csrc/hash_encoder.cu"
    for grid, jac in TRACK_GRIDS:
        spec = specs[grid]
        L, C, T = spec.num_levels, spec.level_dim, spec.total_entries
        table = torch.rand((T, C), generator=g, device=dev) * 2 - 1
        scratch = he.fixed_point_scratch(spec, dev)
        kname = "hash_encode_with_grad" if jac else "hash_encode"
        replaces = "nicer_slam_tpu/ops/hash_encoder.py:" + ("266" if jac else "613")
        g_table = torch.empty_like(table)

        def operands():
            x = ray_points(g, dev, TRACK_RAYS, 98)
            gf = torch.randn((x.shape[0], L * C), generator=g, device=dev)
            gd = (torch.randn((x.shape[0], L * C, 3), generator=g, device=dev) if jac
                  else None)
            return x, gf, gd

        def autograd_table(x, gf, gd):
            tt = table.clone().requires_grad_(True)
            out = he.hash_encode_plain(spec, tt, x, 1.0, jac)
            loss = (out[0] * gf).sum() + (out[1] * gd).sum() if jac else (out * gf).sum()
            return torch.autograd.grad(loss, [tt])[0]

        # two launches in a row, other points
        (x1, gf1, gd1), (x2, gf2, gd2) = operands(), operands()
        zero_after = []
        for x, gf, gd in ((x1, gf1, gd1), (x2, gf2, gd2)):
            he.hash_encode_bwd_launch(spec, table, x, 1.0, jac, gf, gd, g_table, None)
            zero_after.append(he.fixed_point_state_is_zero(spec, scratch))
        exact = bool(torch.equal(g_table, he.hash_table_grad_fixed_plain(spec, x2, gf2, gd2)))
        pgt, pms = timed_once(lambda: autograd_table(x2, gf2, gd2))
        et = rel_l2(g_table, pgt)
        only_first = touched_mask(spec, x1) & ~touched_mask(spec, x2)
        first_zero = not bool(g_table[only_first].any())

        def bwd():
            he.hash_encode_bwd_launch(spec, table, x2, 1.0, jac, gf2, gd2, g_table, None)

        ms = cuda_time(bwd)
        zero_after.append(he.fixed_point_state_is_zero(spec, scratch))
        N, rows = x2.shape[0], touched_rows(spec, x2)
        chk.record(f"{kname}.bwd[{grid}/track/two launches]", src, replaces,
                   max_abs(g_table, pgt),
                   exact and et <= GRAD_REL_L2 and first_zero and all(zero_after), ms, pms,
                   *hash_cost(spec, N, rows, jac, True),
                   f"(second launch: bit for bit with its plain version {exact}, rel L2 "
                   f"{et:.2e}; the {int(only_first.sum())} rows only the first launch "
                   f"touched read 0: {first_zero}; state zero after each: {zero_after})")
        # a NaN cotangent at one level
        gfn = gf1.clone()
        gfn[7, NAN_LEVEL * C] = float("nan")

        def bwd_nan():
            he.hash_encode_bwd_launch(spec, table, x1, 1.0, jac, gfn, gd1, g_table, None)

        bwd_nan()
        zero = he.fixed_point_state_is_zero(spec, scratch)
        r0, r1 = spec.offsets[NAN_LEVEL], spec.offsets[NAN_LEVEL + 1]
        other = torch.ones(T, dtype=torch.bool, device=dev)
        other[r0:r1] = False
        level_nan = bool(g_table[r0:r1].isnan().all())
        plain = he.hash_table_grad_fixed_plain(spec, x1, gfn, gd1)
        exact = bool(torch.equal(g_table[other], plain[other]) and plain[r0:r1].isnan().all())
        pgt, pms = timed_once(lambda: autograd_table(x1, gfn, gd1))
        et = rel_l2(g_table[other], pgt[other])
        ms = cuda_time(bwd_nan)
        zero &= he.fixed_point_state_is_zero(spec, scratch)
        chk.record(f"{kname}.bwd[{grid}/track/NaN at level {NAN_LEVEL}]", src, replaces,
                   max_abs(g_table[other], pgt[other]),
                   level_nan and exact and et <= GRAD_REL_L2 and zero, ms, pms,
                   *hash_cost(spec, x1.shape[0], touched_rows(spec, x1), jac, True),
                   f"(level {NAN_LEVEL}: NaN in all {r1 - r0} rows {level_nan}; the other "
                   f"levels bit for bit with the plain version {exact}, rel L2 {et:.2e} "
                   f"to autograd; state zero after the launch and the timed ones: {zero})")
        del table, g_table, scratch, x1, x2, gf1, gf2, gd1, gd2, gfn, pgt, plain, other
        del only_first
        torch.cuda.empty_cache()


# K1 and K2 at the channel counts below 8 that no shipped grid has (the
# segmented kernels, one segment of C channels; the shipped grids are C
# 8, 4, 2):
# (levels, channels, jac) on a tracking iteration's count of uniform points
HASH_CHANNEL_CASES = ((16, 1, True), (8, 3, True), (6, 5, False), (8, 6, True),
                      (4, 7, True))


def check_hash_channels(dev, chk: Checks):
    import torch
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    g = torch.Generator(device=dev)
    g.manual_seed(9)
    for L, C, jac in HASH_CHANNEL_CASES:
        spec = he.make_spec(input_dim=3, num_levels=L, level_dim=C, per_level_scale=2.0,
                            base_resolution=16, log2_hashmap_size=17,
                            desired_resolution=256)
        table = torch.rand((spec.total_entries, C), generator=g, device=dev) * 2 - 1
        check_hash_case(dev, chk, g, spec, table, jac, uniform_points(g, dev, 1024 * 98),
                        f"[L{L} C{C}/uniform]")
        del table
        torch.cuda.empty_cache()


# K1/K2 (and K3) beyond 32 levels or 8 channels, as the JAX package takes
# them: (levels, channels) of a 40-level grid (two launches of 20), a
# 16 x 16 grid (a level in two segments of 8) and an 8 x 12 one (segments
# of 6), on a tracking iteration's count of ray-ordered points; K1 and K2
# at each, and K3 from the same table rounded to bf16
HASH_WIDE_CASES = ((40, 2), (16, 16), (8, 12))


def wide_spec(L: int, C: int):
    from nicer_slam_tpu_torch.ops import hash_encoder as he
    return he.make_spec(input_dim=3, num_levels=L, level_dim=C, base_resolution=16,
                        log2_hashmap_size=17, desired_resolution=512)


def check_hash_wide(dev, chk: Checks):
    import torch
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    g = torch.Generator(device=dev)
    g.manual_seed(12)
    for L, C in HASH_WIDE_CASES:
        spec = wide_spec(L, C)
        table = torch.rand((spec.total_entries, C), generator=g, device=dev) * 2 - 1
        x = ray_points(g, dev, TRACK_RAYS, 98)
        for jac in (True, False):
            check_hash_case(dev, chk, g, spec, table, jac, x, f"[L{L} C{C}/ray]")
        packed = he.pack_table_bf16(table)
        N = x.shape[0]
        ko = he.hash_encode_bf16(spec, packed, x)
        po = he.hash_encode_bf16_plain(spec, packed, x)
        ms = cuda_time(lambda: he.hash_encode_bf16(spec, packed, x))
        pms = cuda_time(lambda: he.hash_encode_bf16_plain(spec, packed, x), iters=3,
                        warmup=1)
        chk.values(f"hash_encode_bf16[L{L} C{C}/ray]", "nicer_slam_tpu_torch/csrc/"
                   "hash_encoder.cu", "nicer_slam_tpu/ops/hash_encoder.py:858", [ko], [po],
                   ms, pms, (f"feats, bit-equal {bool(torch.equal(ko, po))}, {N} points",),
                   nbytes(x, ko) + touched_rows(spec, x) * C * 2, 2 * C * 8 * L * N)
        del table, packed, ko, po, x
        torch.cuda.empty_cache()


# a tracking iteration's 1024 rays x 98 samples, ray-ordered: K1 on both
# SDF grids and K2 on the colour grid (the demo colours every sample), the
# backward as tracking runs it (the map is fixed: no table gradient, grad_x
# only)
TRACK_RAYS = 1024
TRACK_GRIDS = (("fine", True), ("coarse", True), ("color", False))


def check_hash_tracking(dev, chk: Checks):
    """K1 and K2 forward and backward at the tracking shape, each launch
    timed alone; the backward against the plain version's grad_x."""
    import torch
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    specs = hash_specs()
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    src = "nicer_slam_tpu_torch/csrc/hash_encoder.cu"
    for grid, jac in TRACK_GRIDS:
        spec = specs[grid]
        L, C = spec.num_levels, spec.level_dim
        table = torch.rand((spec.total_entries, C), generator=g, device=dev) * 2 - 1
        x = ray_points(g, dev, TRACK_RAYS, 98)
        N, rows = x.shape[0], touched_rows(spec, x)
        tag = f"[{grid}/track/ray]"
        kname = "hash_encode_with_grad" if jac else "hash_encode"
        replaces = "nicer_slam_tpu/ops/hash_encoder.py:" + ("266" if jac else "177")
        feats = torch.empty((N, L * C), device=dev)
        dfeat = torch.empty((N, L * C, 3), device=dev) if jac else None

        def fwd():
            he.hash_encode_fwd_launch(spec, table, x, 1.0, feats, dfeat)

        fwd()
        po, pms = timed_once(lambda: he.hash_encode_plain(spec, table, x, 1.0, jac))
        po = list(po) if jac else [po]
        chk.values(f"{kname}.fwd{tag}", src, replaces, [feats, dfeat] if jac else [feats],
                   po, cuda_time(fwd), pms, ("feats", "dfeat"),
                   *hash_cost(spec, N, rows, jac, False))
        gf = torch.randn((N, L * C), generator=g, device=dev)
        gd = torch.randn((N, L * C, 3), generator=g, device=dev) if jac else None
        g_x = torch.empty((N, 3), device=dev)

        def bwd():
            he.hash_encode_bwd_launch(spec, table, x, 1.0, jac, gf, gd, None, g_x)

        bwd()
        xx = x.clone().requires_grad_(True)

        def plain_bwd():
            out = he.hash_encode_plain(spec, table, xx, 1.0, jac)
            loss = (out[0] * gf).sum() + (out[1] * gd).sum() if jac else (out * gf).sum()
            return torch.autograd.grad(loss, [xx])[0]

        pgx, pms = timed_once(plain_bwd)
        ex = rel_l2(g_x, pgx)
        chk.record(f"{kname}.bwd{tag}", src,
                   replaces if jac else "nicer_slam_tpu/ops/hash_encoder.py:613",
                   max_abs(g_x, pgx), ex <= GRAD_REL_L2, cuda_time(bwd), pms,
                   *hash_cost(spec, N, rows, jac, True, table_grad=False),
                   f"(rel L2 grad_x {ex:.2e}; {N} points, {rows} rows; no table gradient)")
        del po, xx, pgx, table, feats, dfeat, gf, gd, g_x, x
        torch.cuda.empty_cache()


# the plain composite's shapes: the demo's mapping rays, a render chunk of
# the vis call, and a general shape the paths do not give it (the backward
# at 32 rounds, S > 128)
COMPOSITE_SHAPES = ((4096, 98), (2580, 98), (64, 200))
COMPOSITE_TAGS = ("", "[render chunk 2580x98]", "[general 64x200]")


def check_demo_kernels(dev, chk: Checks, R: int = 4096, S: int = 98, tag: str = ""):
    """K4 at the demo slice's shapes, or at the R x S that `tag` names."""
    import torch
    from nicer_slam_tpu_torch.ops import volume_rendering as vr

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cu = "nicer_slam_tpu_torch/csrc/"

    # ---- K4 composite at R x S
    z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 3.0, dim=1)[0]
    dens = torch.rand((R, S), generator=g, device=dev) * 20.0
    rgb = torch.rand((R, S, 3), generator=g, device=dev)
    nrm = torch.randn((R, S, 3), generator=g, device=dev)
    gouts = [torch.randn(s, generator=g, device=dev) for s in ((R, S), (R, 3), (R, 1), (R, 3))]
    with torch.no_grad():
        ko, po = vr.composite(z, dens, rgb, nrm), vr.composite_plain(z, dens, rgb, nrm)
        ms = cuda_time(lambda: vr.composite(z, dens, rgb, nrm))
        pms = cuda_time(lambda: vr.composite_plain(z, dens, rgb, nrm))
    chk.values(f"composite.fwd{tag}", cu + "composite.cu",
               "nicer_slam_tpu/ops/volume_rendering.py:15", ko, po, ms, pms,
               ("weights", "rgb", "depth", "normal"), nbytes(z, dens, rgb, nrm, *ko),
               R * S * 30)
    ins_k = [t.clone().requires_grad_(True) for t in (dens, rgb, nrm)]
    ins_p = [t.clone().requires_grad_(True) for t in (dens, rgb, nrm)]
    kl = sum((o * go).sum() for o, go in zip(vr.composite(z, *ins_k), gouts))
    pl = sum((o * go).sum() for o, go in zip(vr.composite_plain(z, *ins_p), gouts))
    kg = torch.autograd.grad(kl, ins_k, retain_graph=True)
    pg = torch.autograd.grad(pl, ins_p, retain_graph=True)
    errs = [rel_l2(a, b) for a, b in zip(kg, pg)]
    # the backward kernel's launch alone, on the same cotangents
    ms = cuda_time(lambda: vr._composite_bwd("composite.bwd", z, dens, rgb, nrm, *gouts))
    pms = cuda_time(lambda: torch.autograd.grad(pl, ins_p, retain_graph=True))
    chk.record(f"composite.bwd{tag}", cu + "composite.cu",
               "nicer_slam_tpu/ops/volume_rendering.py:15",
               max(max_abs(a, b) for a, b in zip(kg, pg)), max(errs) <= GRAD_REL_L2,
               ms, pms, nbytes(z, dens, rgb, nrm, *gouts, *kg), R * S * 60,
               "(rel L2 density/rgb/normals " + "/".join(f"{e:.1e}" for e in errs) + ")")


def sampler_agreement(kz, ke, pz, pe, z_pre) -> dict:
    """Two importance samplers' outputs on the same rays: a ray agrees when
    every z_vals entry and z_eik are within Z_ATOL. A ray may differ at the
    u = 1 inverse-CDF sample alone (ROADMAP queue 3: it follows the last bit
    of the cdf's total, summed in another order): every other sample
    matches within Z_ATOL (a multiset match of the rows) and the odd sample
    lies, in both, within one prepass bin below far (between the ray's
    prepass z[Ne-2] and far); such rays are counted, may be at most 1 % of
    the rays, and their z_eik is not compared. Any other difference fails."""
    err = (kz - pz).abs().amax(1)
    full = (err <= Z_ATOL) & ((ke - pe).abs()[:, 0] <= Z_ATOL)
    off = (~full).nonzero()[:, 0].tolist()
    R = kz.shape[0]
    n_u1 = 0
    if len(off) <= 0.01 * R:
        for r in off:
            if err[r] <= Z_ATOL:
                continue                        # z_vals agree, z_eik does not
            a, b = kz[r].tolist(), pz[r].tolist()
            lo, hi = float(z_pre[r, -2]) - Z_ATOL, float(z_pre[r, -1]) + Z_ATOL
            left, odd = list(b), []
            for v in a:
                k = min(range(len(left)), key=lambda i: abs(left[i] - v))
                if abs(left[k] - v) <= Z_ATOL:
                    left.pop(k)
                else:
                    odd.append(v)
            if len(odd) == 1 and len(left) == 1 and all(lo <= v <= hi for v in odd + left):
                n_u1 += 1
    n_bad = len(off) - n_u1
    return dict(ok=n_bad == 0 and n_u1 <= 0.01 * R, n_off=n_bad, n_u1=n_u1,
                max_err=float(err.max()), median_err=float(err.median()))


def _sampler_record(chk, name, kz, ke, pz, pe, z_pre, ms, pms, R, bytes_, ops, extra):
    a = sampler_agreement(kz, ke, pz, pe, z_pre)
    chk.record(name, "nicer_slam_tpu_torch/csrc/sampler.cu",
               "nicer_slam_tpu/ops/ray_sampling.py:112", a["max_err"], a["ok"], ms, pms,
               bytes_, ops,
               f"(rays off by more than {Z_ATOL:g}: {a['n_off']} of {R}, and {a['n_u1']} "
               f"at the u = 1 sample alone; median ray err {a['median_err']:.1e}; {extra})")


def shell_cache(dev, res: int = 128):
    """A [res³] density volume like a Laplace density of an SDF: a shell
    around a sphere of radius 0.6."""
    import torch
    ii = torch.linspace(-1, 1, res, device=dev)
    gx, gy, gz = torch.meshgrid(ii, ii, ii, indexing="ij")
    sdf = torch.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6
    return (80.0 * torch.sigmoid(-sdf / 0.0125)).reshape(-1).contiguous()


def sampler_inputs(g, dev, R: int):
    """K5's operands at R training rays besides the cache (jittered, 640
    prepass samples, a random perm and eikonal anchors): (cfg, o, d,
    t_rand, perm, eik)."""
    import torch
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    scfg = rs.SamplerConfig(N_samples=64, N_samples_eval=640, N_samples_extra=32,
                            prepass_mode="cached", prepass_cache_res=128)
    o, d = _sampler_rays(g, dev, R)
    t_rand = torch.rand((R, 640), generator=g, device=dev)
    perm = torch.randperm(640, generator=g, device=dev)[:32]
    eik = torch.randint(0, scfg.total_samples, (R,), generator=g, device=dev)
    return scfg, o, d, t_rand, perm, eik


def given_inputs(g, dev, R: int = 2580, training: bool = False):
    """K5 given densities: the prepass z of R rays, their near and far, and
    the Laplace densities of a sphere's SDF there; (cfg, z, near, far,
    density, perm, eik). An eval render's chunk: unjittered z, the
    linspace extras, anchors 0. A training iteration (``training``):
    jittered z, the extras drawn per chunk of 1024 rays ([8, 32] at 8192
    rays, one row at 1024: tracking does not chunk), random anchors."""
    import torch
    from nicer_slam_tpu_torch.ops import density as dens_ops
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    scfg = rs.SamplerConfig(N_samples=64, N_samples_eval=640, N_samples_extra=32)
    o, d = _sampler_rays(g, dev, R)
    t_rand = torch.rand((R, 640), generator=g, device=dev) if training else None
    zs, near, far = rs.uniform_z_vals(scfg, o, d, t_rand)
    sdf = (o[:, None, :] + zs[..., None] * d[:, None, :]).norm(dim=-1) - 0.6
    dens = dens_ops.laplace_density(sdf, torch.tensor(0.0125, device=dev))
    if not training:
        perm = torch.linspace(0, 639, 32, device=dev).to(torch.int64)
        return scfg, zs, near, far, dens, perm, torch.zeros((R,), dtype=torch.int64,
                                                            device=dev)
    perm = torch.stack([torch.randperm(640, generator=g, device=dev)[:32]
                        for _ in range(rs.prepass_chunks(scfg, R))]).squeeze(0)
    eik = torch.randint(0, scfg.total_samples, (R,), generator=g, device=dev)
    return scfg, zs, near, far, dens, perm, eik


def touched_voxels(res: int, pts) -> int:
    """Distinct cache entries that the trilinear reads of the in-range
    points read: the cache bytes K5 must move for these rays."""
    import torch
    pts = pts[(pts.abs() <= 1.0).all(-1)]
    g0 = torch.floor((pts + 1.0) * (0.5 * (res - 1))).to(torch.int64).clamp(0, res - 2)
    base = (g0[:, 0] * res + g0[:, 1]) * res + g0[:, 2]
    mark = torch.zeros(res ** 3, dtype=torch.bool, device=pts.device)
    for c in range(8):
        mark[base + (c & 1) * res * res + ((c >> 1) & 1) * res + ((c >> 2) & 1)] = True
    return int(mark.sum())


# rays of the importance sampler's launches on the paths: tracking, the
# demo's mapping, the flagship's mapping; given densities: a render chunk,
# and the exact prepass of a tracking and of a flagship mapping iteration
SAMPLER_RAYS = (1024, 4096, 8192)
GIVEN_RAYS = 2580
TRAIN_RAYS = (1024, 8192)


def check_sampler_kernels(dev, chk: Checks):
    """K5 (cached prepass) at the tracking and mapping ray counts, and K5
    given densities at one render chunk, each launch timed alone; the bound
    counts the cache by the entries these rays read."""
    import torch
    from nicer_slam_tpu_torch.ops import ray_sampling as rs

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cache = shell_cache(dev)
    whole = nbytes(cache)
    for R in SAMPLER_RAYS:
        scfg, o, d, t_rand, perm, eik = sampler_inputs(g, dev, R)
        kz, ke = rs.importance_sample(scfg, o, d, cache, t_rand, perm, eik)
        pz, pe = rs.importance_sample_plain(scfg, o, d, cache, t_rand, perm, eik)
        ms = cuda_time(lambda: rs.importance_sample(scfg, o, d, cache, t_rand, perm, eik))
        pms = cuda_time(lambda: rs.importance_sample_plain(scfg, o, d, cache, t_rand, perm, eik))
        z_pre = rs.uniform_z_vals(scfg, o, d, t_rand)[0]
        vox = touched_voxels(scfg.prepass_cache_res,
                             (o[:, None, :] + z_pre[..., None] * d[:, None, :]).reshape(-1, 3))
        io = nbytes(o, d, t_rand, perm, eik, kz, ke)
        # per prepass sample a trilinear read and a CDF step (~40
        # operations), per output sample a binary search
        ops = R * 640 * 40 + R * kz.shape[1] * 40
        _sampler_record(chk, f"importance_sample[{R}]", kz, ke, pz, pe, z_pre, ms, pms, R,
                        io + 4 * vox, ops,
                        f"cache by touched voxels: {vox} of {cache.numel()}; bound with the "
                        f"cache whole {bound(io + whole, ops)[0]:.4f} ms")
    del cache, t_rand
    for R, training in [(GIVEN_RAYS, False)] + [(R, True) for R in TRAIN_RAYS]:
        ins = given_inputs(g, dev, R, training)
        kz, ke = rs.importance_sample_given(*ins)
        pz, pe = rs.importance_sample_given_plain(*ins)
        ms = cuda_time(lambda: rs.importance_sample_given(*ins))
        pms = cuda_time(lambda: rs.importance_sample_given_plain(*ins))
        perm = ins[5]
        _sampler_record(chk, f"importance_sample_given[{'train ' if training else ''}{R}]",
                        kz, ke, pz, pe, ins[1], ms, pms, R, nbytes(*ins[1:], kz, ke),
                        R * 640 * 20 + R * kz.shape[1] * 40,
                        "no cache; " + ("jittered z, extras per chunk: perm "
                                        f"{tuple(perm.shape)}" if training else "eval render"))


# K3's points: a density-cache build chunk (build_density_cache's
# linspace(-1, 1, 128)³ grid in its order, chunk 8 of 16), the ray-ordered
# prepass of a render chunk (2580 rays x 640 unjittered z), and as many
# uniform points
BF16_ORDERS = ("cache", "ray", "uniform")


def bf16_points(g, dev, order):
    import torch
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    if order == "cache":
        xs = torch.linspace(-1.0, 1.0, 128, device=dev)
        grid = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
        return grid.chunk(16)[8].contiguous()
    n_rays = GIVEN_RAYS
    if order == "uniform":
        return uniform_points(g, dev, n_rays * 640)
    scfg = rs.SamplerConfig(N_samples=64, N_samples_eval=640, N_samples_extra=32)
    o, d = _sampler_rays(g, dev, n_rays)
    zs, _, _ = rs.uniform_z_vals(scfg, o, d, None)
    return (o[:, None, :] + zs[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()


def hash_specs():
    """The flagship configuration's hash grids: the SDF grids (coarse, fine)
    and the colour grid."""
    from nicer_slam_tpu_torch.config import parse_file
    from nicer_slam_tpu_torch.models import fields
    conf = parse_file(PATHS["flagship"]["conf"]).get_config("model")
    fvs = conf.get_int("feature_vector_size")
    comb = fields.combine_config_from_conf(conf.get_config("implicit_network"), fvs)
    rend = fields.rendering_config_from_conf(conf.get_config("rendering_network"), fvs)
    return {"coarse": comb.coarse.hash_spec(), "fine": comb.fine.hash_spec(),
            "color": rend.hash_spec()}


SDF_GRIDS = ("coarse", "fine")


def sdf_density_cost(n: int, io_bytes: int, voxel_res: int = 64, comb=None):
    """(bytes, operations) of K6 over n points of the SDF networks ``comb``
    (the flagship configuration's by default), the least the card must
    do: read both SDF grids' tables (bf16; fp32 with concat_coarse_feature),
    the weights and the voxel counter once, the points' inputs and outputs
    (``io_bytes``) once; per point the corner sums of each grid with
    features on (2 operations per multiply-add), both MLPs with only the
    SDF row of each last layer (the coarse one's whole last layer with
    concat; 2 per weight) and ~30 for the positional encoding and the
    density."""
    if comb is None:
        comb = flagship_combine()
    concat = comb.fine.concat_coarse_feature
    bytes_, per_pt = io_bytes + 4 * voxel_res ** 3, 30
    for cfg in (comb.coarse, comb.fine):
        spec, dims = cfg.hash_spec(), cfg.layer_dims
        rows = dims[-1] if concat and cfg is comb.coarse else 1
        weights = sum(dims[i] * (dims[i + 1] - (dims[0] if i + 1 in cfg.skip_in else 0))
                      for i in range(len(dims) - 2)) + dims[-2] * rows
        if cfg.use_grid_feature:
            bytes_ += (4 if concat else 2) * spec.total_entries * spec.level_dim
            per_pt += 2 * spec.level_dim * 8 * spec.num_levels
        bytes_ += 4 * (weights + sum(dims[1:-1]) + rows)
        per_pt += 2 * weights
    return bytes_, per_pt * n


def flagship_combine():
    """The flagship configuration's SDF networks (their config)."""
    from nicer_slam_tpu_torch.config import parse_file
    from nicer_slam_tpu_torch.models import fields
    conf = parse_file(PATHS["flagship"]["conf"]).get_config("model")
    return fields.combine_config_from_conf(conf.get_config("implicit_network"),
                                           conf.get_int("feature_vector_size"))


def density_cache_cost(res: int = 128, voxel_res: int = 64):
    """(bytes, operations) of one density-cache build: K6 over the res³
    grid (the res coordinates in, the cache out)."""
    return sdf_density_cost(res ** 3, 4 * res + 4 * res ** 3, voxel_res)


def sdf_net(dev):
    """The flagship configuration's SDF networks on the card, seeded as the
    runner seeds them (seed 0, the fine MLP from pretrain.npz), with both
    tables drawn U(-0.05, 0.05) (features at a trained map's scale, where
    the init's 1e-4 would leave them out of the sums), and a voxel counter
    of counts 0-199."""
    import numpy as np
    import torch
    from nicer_slam_tpu_torch.config import parse_file
    from nicer_slam_tpu_torch.models import fields
    conf = parse_file(PATHS["flagship"]["conf"]).get_config("model")
    comb = fields.combine_config_from_conf(conf.get_config("implicit_network"),
                                           conf.get_int("feature_vector_size"))
    net = fields.CombineNet(comb, np.random.default_rng(0))
    g = torch.Generator().manual_seed(5)
    with torch.no_grad(), np.load(os.path.join(ROOT, "pretrain.npz")) as data:
        for i, lin in enumerate(net.fine.lins):
            for k, p in lin.named_parameters():
                if f"fine_lin{i}_{k}" in data.files:
                    p.copy_(torch.from_numpy(data[f"fine_lin{i}_{k}"]))
        for sub in (net.coarse, net.fine):
            sub.encoding.copy_(torch.rand(sub.encoding.shape, generator=g) * 0.1 - 0.05)
    vox = torch.randint(0, 200, (64, 64, 64), generator=g).to(torch.float32)
    return net.to(dev), vox.to(dev)


def density_f64(net, pack, x, voxels):
    """The density at x in float64 from the packed weights (the kernel's
    layer order) and K3's features, beta from K7's plain read: the
    reference that both versions' float32 rounding is measured against."""
    import torch
    from nicer_slam_tpu_torch.ops import density as dens_ops
    from nicer_slam_tpu_torch.ops import sdf_density as sd
    out, flat = [], sd.pack_sdf_weights(net)
    for xc in x.split(131072):
        sdf = sd.sdf_packed_reference(net, pack.tables, flat, xc, torch.float64)
        beta = dens_ops.grid_predefined_beta_plain(voxels, xc)[:, 0].double()
        out.append(dens_ops.laplace_density(sdf, beta))
    return torch.cat(out)


def device_ops(fn) -> int:
    """Device operations (kernels, memory copies and sets) of one call of
    fn under torch.profiler."""
    import torch
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


SDF_RES = 128
# the shipped network's K6 times on record (PERF.md section 6, the kernel
# table; NVIDIA H100 80GB HBM3, 700 W): the 128³ cache and a flagship
# mapping iteration's exact prepass (8192 x 640 jittered z)
SHIPPED_RECORD_MS = {"grid": {128: 2.716}, "rays": {8192: 5.999}}


def check_sdf_density(dev, chk: Checks):
    """K6 in both modes against its plain version (K3, the MLPs, K7's read
    and the Laplace density, as the port ran them before the kernel): the
    128³ density cache and the exact prepass of a 2580-ray render chunk
    (640 unjittered z a ray); each call must launch sdf_density once and
    no other kernel. Both versions are also measured against float64."""
    import torch
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    from nicer_slam_tpu_torch.ops import sdf_density as sd

    net, vox = sdf_net(dev)
    pack = sd.pack_sdf(net)
    src = "nicer_slam_tpu_torch/csrc/sdf_density.cu"

    def one_launch(fn, mode):
        _cuda.reset_launch_counts()
        out = fn()
        counts = {k: v for k, v in _cuda.launch_counts().items() if v}
        _cuda.reset_launch_counts()
        return out, counts == {f"sdf_density.{mode}": 1}, counts

    def record(tag, rep, ko, po, exact, ms, pms, cost, single, counts, extra):
        err, scale = max_abs(ko, po), float(po.abs().max())
        ek = float((ko.double() - exact).abs().max()) / scale
        ep = float((po.double() - exact).abs().max()) / scale
        chk.record(f"sdf_density.{tag}", src, rep, err,
                   err <= SDF_DENSITY_RTOL * scale and single, ms, pms, *cost,
                   f"(err {err / scale:.2e} of max {scale:.4g}, tolerance "
                   f"{SDF_DENSITY_RTOL:g}; against float64: kernel {ek:.2e}, plain "
                   f"{ep:.2e}; one launch and no other: {single} {counts}; {extra})")

    # the density cache: 128³ grid points, and the device operations of one
    # build (the pack of tables and weights, then the launch); the shipped
    # kernel's times beside those on record (same card and power limit)
    ko, single, counts = one_launch(lambda: sd.density_grid(net, pack, SDF_RES, vox), "grid")
    po = sd.density_grid_plain(net, pack.tables, SDF_RES, vox)
    xs = torch.linspace(-1.0, 1.0, SDF_RES, device=dev)
    exact = density_f64(net, pack, sd.grid_points(xs, torch.arange(SDF_RES ** 3, device=dev)),
                        vox)
    ms = cuda_time(lambda: sd.density_grid(net, pack, SDF_RES, vox))
    pms = cuda_time(lambda: sd.density_grid_plain(net, pack.tables, SDF_RES, vox), iters=3,
                    warmup=1)
    n_ops = device_ops(lambda: sd.density_grid(net, sd.pack_sdf(net), SDF_RES, vox))
    build_ms = cuda_time(lambda: sd.density_grid(net, sd.pack_sdf(net), SDF_RES, vox))
    record(f"grid[{SDF_RES}^3]", "nicer_slam_tpu/models/scene_model.py:108", ko, po, exact,
           ms, pms, density_cache_cost(SDF_RES), single, counts,
           f"a build with its pack: {n_ops} device operations, {build_ms:.3f} ms; "
           f"on record: {SHIPPED_RECORD_MS['grid'][SDF_RES]} ms, now "
           f"{ms / SHIPPED_RECORD_MS['grid'][SDF_RES] - 1:+.1%}")
    del ko, po, exact
    # the exact prepass of a render chunk (2580 rays x 640 unjittered z) and
    # of a tracking and a flagship mapping iteration (1024 and 8192 rays x
    # 640 jittered z: 5.2M points in one launch at 8192)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    scfg = rs.SamplerConfig(N_samples=64, N_samples_eval=640, N_samples_extra=32)
    for R, training in [(GIVEN_RAYS, False)] + [(R, True) for R in TRAIN_RAYS]:
        o, d = _sampler_rays(g, dev, R)
        t_rand = torch.rand((R, 640), generator=g, device=dev) if training else None
        z, _, _ = rs.uniform_z_vals(scfg, o, d, t_rand)
        ko, single, counts = one_launch(lambda: sd.density_rays(net, pack, o, d, z, vox),
                                        "rays")
        po = sd.density_rays_plain(net, pack.tables, o, d, z, vox)
        exact = density_f64(net, pack, sd.ray_points(o, d, z), vox).reshape(z.shape)
        ms = cuda_time(lambda: sd.density_rays(net, pack, o, d, z, vox))
        pms = cuda_time(lambda: sd.density_rays_plain(net, pack.tables, o, d, z, vox),
                        iters=3, warmup=1)
        record(f"rays[{'train ' if training else ''}{R}x640]",
               "nicer_slam_tpu/models/scene_model.py:246", ko, po, exact, ms, pms,
               sdf_density_cost(z.numel(), nbytes(o, d, z, ko)), single, counts,
               f"{z.numel()} points, {int((po > 1.0).sum())} with density above 1"
               + ("; jittered z" if training else "")
               + (f"; on record: {SHIPPED_RECORD_MS['rays'][R]} ms, now "
                  f"{ms / SHIPPED_RECORD_MS['rays'][R] - 1:+.1%}"
                  if training and R in SHIPPED_RECORD_MS["rays"] else ""))
        del ko, po, exact
        torch.cuda.empty_cache()
    del net, vox, pack
    torch.cuda.empty_cache()


# the general K6 (sdf_density_general) and its concat variant: SDF networks
# that the JAX package runs and the shipped kernel does not serve, as
# implicit_network blocks (feature_vector_size, then the text): the JAX
# package's end-to-end test conf (tests/test_slam_e2e.py TINY_CONF), the
# port's parity-test networks (tests/_torch_tiny.py), and one with skip_in,
# the fine clamp, divide_factor 1.5, multires 0 and a 16 x 2 grid; then the
# flagship's networks with a VolSDF-like fine network (8 x 256, skip_in
# [4], geometric init) and with concat_coarse_feature
GENERAL_NETS = {
    "tiny-jax": (16, """
        coarse {
            d_in = 3  d_out = 1  dims = [ 32 ]
            geometric_init = true  bias = 0.9  skip_in = []
            weight_norm = true  multires = 6  inside_outside = true
            use_grid_feature = true
            base_size = 16  end_size = 16  logmap = 15
            num_levels = 2  level_dim = 4  divide_factor = 1.0
        }
        fine {
            d_in = 3  d_out = 1  dims = [ 32 32 ]
            geometric_init = false  bias = 0.9  skip_in = []
            weight_norm = true  multires = 6  inside_outside = true
            use_grid_feature = true
            base_size = 16  end_size = 64  logmap = 17
            num_levels = 4  level_dim = 2  divide_factor = 1.0
        }"""),
    "tiny-port": (8, """
        coarse {
            d_in = 3  d_out = 1  dims = [ 16 ]
            geometric_init = true  bias = 0.6  skip_in = []
            weight_norm = true  multires = 6  inside_outside = true
            use_grid_feature = true
            base_size = 8  end_size = 8  logmap = 12
            num_levels = 2  level_dim = 8  divide_factor = 1.0
        }
        fine {
            d_in = 3  d_out = 1  dims = [ 16 16 ]
            geometric_init = false  bias = 0.6  skip_in = []
            weight_norm = true  multires = 6  inside_outside = true
            use_grid_feature = true
            base_size = 8  end_size = 32  logmap = 10
            num_levels = 3  level_dim = 4  divide_factor = 1.0
        }"""),
    "skip-clamp": (16, """
        coarse {
            d_in = 3  d_out = 1  dims = [ 32 ]
            geometric_init = true  bias = 0.9  skip_in = []
            weight_norm = true  multires = 0  inside_outside = true
            use_grid_feature = true
            base_size = 16  end_size = 16  logmap = 15
            num_levels = 2  level_dim = 4  divide_factor = 1.5
        }
        fine {
            d_in = 3  d_out = 1  dims = [ 64 64 64 64 ]
            geometric_init = false  bias = 0.9  skip_in = [ 2 ]  clamp = true
            weight_norm = true  multires = 0  inside_outside = true
            use_grid_feature = true
            base_size = 16  end_size = 512  logmap = 16
            num_levels = 16  level_dim = 2  divide_factor = 1.5
        }"""),
    "odd-widths": (16, """
        coarse {
            d_in = 3  d_out = 1  dims = [ 20 ]
            geometric_init = true  bias = 0.9  skip_in = []
            weight_norm = true  multires = 2  inside_outside = true
            use_grid_feature = true
            base_size = 16  end_size = 16  logmap = 15
            num_levels = 2  level_dim = 4  divide_factor = 1.0
        }
        fine {
            d_in = 3  d_out = 1  dims = [ 36 36 36 ]
            geometric_init = false  bias = 0.9  skip_in = [ 2 ]
            weight_norm = true  multires = 1  inside_outside = true
            use_grid_feature = true
            base_size = 16  end_size = 64  logmap = 17
            num_levels = 3  level_dim = 6  divide_factor = 1.0
        }"""),
}
GENERAL_RES = 128


def general_net(dev, which: str):
    """(net, voxels) for GENERAL_NETS[which], "volsdf-8x256" or "concat",
    seeded as sdf_net: tables U(-0.05, 0.05), a voxel counter of counts
    0-199."""
    import numpy as np
    import torch
    from nicer_slam_tpu_torch.config import parse_string
    from nicer_slam_tpu_torch.models import fields
    if which in GENERAL_NETS or which in LIMIT_NETS:
        fvs, text = {**GENERAL_NETS, **LIMIT_NETS}[which]
        comb = fields.combine_config_from_conf(
            parse_string(f"implicit_network {{{text}\n}}").get_config("implicit_network"), fvs)
    else:
        comb = flagship_combine()
        fine = (comb.fine._replace(dims=(256,) * 8, skip_in=(4,), geometric_init=True,
                                   bias=0.6)
                if which == "volsdf-8x256" else comb.fine._replace(concat_coarse_feature=True))
        comb = comb._replace(fine=fine)
    net = fields.CombineNet(comb, np.random.default_rng(0))
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for sub in (net.coarse, net.fine):
            sub.encoding.copy_(torch.rand(sub.encoding.shape, generator=g) * 0.1 - 0.05)
    vox = torch.randint(0, 200, (64, 64, 64), generator=g).to(torch.float32)
    return net.to(dev), vox.to(dev)


def general_density_f64(net, pack, x, voxels, chunk=131072):
    """The density at x in float64 from the general kernel's packed weights
    (its layer order and padding), beta from K7's plain read."""
    import torch
    from nicer_slam_tpu_torch.ops import density as dens_ops
    from nicer_slam_tpu_torch.ops import sdf_density as sd
    out = []
    for xc in x.split(chunk):
        sdf = sd.sdf_general_reference(net, pack.tables, pack.weights, pack.desc, xc,
                                       torch.float64)
        beta = dens_ops.grid_predefined_beta_plain(voxels, xc)[:, 0].double()
        out.append(dens_ops.laplace_density(sdf, beta))
    return torch.cat(out)


# the cases of check_sdf_general and tools/sdf_density_ab.py: (network,
# mode, rays, z a ray, jittered): the GENERAL_NETS in grid mode (128³) and
# ray mode (a render chunk, 2580 x 640), the 8 x 256 network on a render
# chunk, and the concat variant at flagship widths on a render chunk, a
# flagship mapping iteration's 8192 x 640 and a tracking iteration's 1024
# x 640 jittered z, and a ragged launch of 1001 x 601 jittered z (601,601
# points: a multiple of no tile)
GENERAL_CASES = ([(w, m, GIVEN_RAYS if m == "rays" else 0, 640, False)
                  for w in GENERAL_NETS for m in ("grid", "rays")]
                 + [("volsdf-8x256", "rays", GIVEN_RAYS, 640, False),
                    ("concat", "rays", GIVEN_RAYS, 640, False),
                    ("concat", "rays", 8192, 640, True),
                    ("concat", "rays", 1024, 640, True),
                    ("concat", "rays", 1001, 601, True)])


def general_case(dev, g, case):
    """The operands of one GENERAL_CASES entry (rays drawn from g, in the
    list's order): a namespace with net, vox, pack (this checkout's), tag,
    mode, kw (the kernel's mode operands: xs and res, or o, d, z and S), x
    (the points), run() (this checkout's launch), plain(), cost (bytes,
    operations) and a note."""
    import types
    import torch
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    from nicer_slam_tpu_torch.ops import sdf_density as sd
    which, mode, R, S, jitter = case
    net, vox = general_net(dev, which)
    c = types.SimpleNamespace(net=net, vox=vox, pack=sd.pack_sdf(net), mode=mode)
    if mode == "grid":
        xs = torch.linspace(-1.0, 1.0, GENERAL_RES, device=dev)
        c.kw = dict(xs=xs, res=GENERAL_RES)
        c.x = sd.grid_points(xs, torch.arange(GENERAL_RES ** 3, device=dev))
        c.tag = f"{which} {GENERAL_RES}^3"
        c.run = lambda: sd.density_grid(net, c.pack, GENERAL_RES, vox)
        c.plain = lambda: sd.density_grid_plain(net, c.pack.tables, GENERAL_RES, vox)
        c.cost = sdf_density_cost(GENERAL_RES ** 3, 4 * GENERAL_RES + 4 * GENERAL_RES ** 3,
                                  comb=net.cfg)
    else:
        scfg = rs.SamplerConfig(N_samples=64, N_samples_eval=640, N_samples_extra=32)
        o, d = _sampler_rays(g, dev, R)
        t_rand = torch.rand((R, 640), generator=g, device=dev) if jitter else None
        z = rs.uniform_z_vals(scfg, o, d, t_rand)[0][:, :S].contiguous()
        c.kw = dict(o=o, d=d, z=z, S=S)
        c.x = sd.ray_points(o, d, z)
        c.tag = f"{which} {'train ' if jitter else ''}{R}x{S}"
        c.run = lambda: sd.density_rays(net, c.pack, o, d, z, vox)
        c.plain = lambda: sd.density_rays_plain(net, c.pack.tables, o, d, z, vox)
        c.cost = sdf_density_cost(z.numel(), nbytes(o, d, z) + 4 * z.numel(), comb=net.cfg)
    c.note = f"{c.x.shape[0]} points" + ("; jittered z" if jitter else "")
    return c


def check_sdf_general(dev, chk: Checks, cases=GENERAL_CASES, strict: bool = False):
    """The general K6 and its concat variant against their plain versions
    on GENERAL_CASES (each one launch and no other kernel; within
    SDF_DENSITY_RTOL of the largest density; both versions also measured
    against float64), or on ``cases``; ``strict``: the kernel must also be
    no further from float64 than the plain version."""
    import torch
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.ops import sdf_density as sd

    src = "nicer_slam_tpu_torch/csrc/sdf_density.cu"
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    for case in cases:
        c = general_case(dev, g, case)
        want = "concat" if case[0] == "concat" else "general"
        if c.pack.variant != want:
            chk.failures.append(f"sdf_density: {case[0]} got the {c.pack.variant} variant")
            continue
        kname = f"sdf_density_{c.pack.variant}.{c.mode}"
        _cuda.reset_launch_counts()
        ko = c.run()
        counts = {k: v for k, v in _cuda.launch_counts().items() if v}
        _cuda.reset_launch_counts()
        single = counts == {kname: 1}
        po = c.plain()
        exact = general_density_f64(c.net, c.pack, c.x, c.vox,
                                    32768 if max(c.net.cfg.fine.dims) > 64 else 131072)
        exact = exact.reshape(po.shape)
        err, scale = max_abs(ko, po), float(po.abs().max())
        ek = float((ko.double() - exact).abs().max()) / scale
        ep = float((po.double() - exact).abs().max()) / scale
        ms = cuda_time(c.run)
        pms = cuda_time(c.plain, iters=3, warmup=1)
        tile, smem, w_smem = sd.general_plan(c.pack)
        w_floats = c.pack.weights.numel()
        if c.pack.act_floats:
            c.note += (f"; activations in device memory ({c.pack.act_floats} floats for the "
                       f"blocks the card runs at once)")
        if c.pack.ext is not None:
            c.note += f"; {c.pack.ext.numel()} ints of layers and segments past the parameters"
        if strict:
            c.note += f"; kernel no further from float64 than plain: {ek <= ep}"
        chk.record(f"{kname}[{c.tag}]", src, "nicer_slam_tpu/models/scene_model.py:"
                   + ("108" if c.mode == "grid" else "246"), err,
                   err <= SDF_DENSITY_RTOL * scale and single and (ek <= ep or not strict),
                   ms, pms, *c.cost,
                   f"(err {err / scale:.2e} of max {scale:.4g}, tolerance "
                   f"{SDF_DENSITY_RTOL:g}; against float64: kernel {ek:.2e}, plain "
                   f"{ep:.2e}; one launch and no other: {single} {counts}; tile {tile} "
                   f"points, {smem} B shared, weights "
                   f"{'resident' if w_smem == w_floats else f'streamed through a ring of {w_smem} floats'}"
                   f" ({w_floats} floats); {c.note})")
        del c, ko, po, exact
        torch.cuda.empty_cache()


# phase 3's cases past the kernels' old limits (the JAX package has none):
# networks for the general K6, the tiny-port networks with a deeper or a
# wider fine network: 20 layers of 8 units, one layer of 1280 units (column
# slices, tiles of 16 points) and one of 3072 (its activations in device
# memory)
LIMIT_NETS = {
    name: (8, GENERAL_NETS["tiny-port"][1].replace(
        "d_in = 3  d_out = 1  dims = [ 16 16 ]", f"d_in = 3  d_out = 1  dims = [ {dims} ]"))
    for name, dims in (("deep-20", " ".join(["8"] * 19)), ("wide-1280", "1280 64"),
                       ("wide-3072", "3072 64"))}
LIMIT_SDF_CASES = [("deep-20", "grid", 0, 640, False),
                   ("deep-20", "rays", GIVEN_RAYS, 640, False),
                   ("wide-1280", "rays", 256, 640, False),
                   ("wide-3072", "rays", 256, 640, False)]
# K5 (both modes) at 1024 rays: prepass counts past 1024 (40,000 keeps a
# ray's rows in the global scratch) and sorted counts St = Ns + 2 + Nextra
# of 162, 300 and 1100 (8 and 16 keys a lane, the sort in the row);
# K4's composite at 600 and 1100 samples, weights_topk at 1100
LIMIT_RAYS = 1024
LIMIT_SAMPLER = ((1280, 64, 32), (4096, 64, 32), (40_000, 64, 32), (640, 128, 32),
                 (640, 200, 98), (640, 1000, 98))
LIMIT_COMPOSITE = (600, 1100)
LIMIT_TOPK = ((1100, 16),)
# the shipped shapes' times on record (PERF.md section 6; NVIDIA H100 80GB
# HBM3, 700 W), printed beside the cases past the limits
RECORD_MS = {
    "K5": "importance_sample 0.0190 / 0.0371 / 0.0632 ms at 1024 / 4096 / 8192 rays, given "
          "0.0124 / 0.0372 ms at 1024 / 8192 (Ne 640, St 98)",
    "K4": "composite.fwd 0.0092 ms at 4096 x 98, weights_topk.fwd 0.0093 / 0.0173 ms at "
          "1024 / 8192 x 98",
    "K6": "sdf_density 2.716 ms for the 128^3 cache, concat 3.770 ms for 2580 x 640",
    "K9": "tsdf.integrate 0.0974 ms (the first design, a thread a voxel)",
}


def check_sampler_limits(dev, chk: Checks):
    """K5 in both modes past its old limits (LIMIT_SAMPLER at LIMIT_RAYS
    rays), each against its plain version: bit for bit on every ray, and
    within the sampler's agreement rule."""
    import torch
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.ops import density as dens_ops
    from nicer_slam_tpu_torch.ops import ray_sampling as rs

    g = torch.Generator(device=dev)
    g.manual_seed(11)
    cache = shell_cache(dev)
    R = LIMIT_RAYS
    log(f"  on record for the shipped shapes: {RECORD_MS['K5']}")
    for Ne, Ns, Nx in LIMIT_SAMPLER:
        scfg = rs.SamplerConfig(N_samples=Ns, N_samples_eval=Ne, N_samples_extra=Nx,
                                prepass_mode="cached", prepass_cache_res=128)
        St = scfg.total_samples
        o, d = _sampler_rays(g, dev, R)
        t_rand = torch.rand((R, Ne), generator=g, device=dev)
        perm = torch.randperm(Ne, generator=g, device=dev)[:Nx]
        eik = torch.randint(0, St, (R,), generator=g, device=dev)
        where = ("rows in the global scratch"
                 if _cuda.library().nsl_importance_sample_rows(Ne, Ns, Nx) > 0
                 else "rows in shared memory")
        z_pre, near, far = rs.uniform_z_vals(scfg, o, d, t_rand)
        tag = f"[{R} Ne{Ne} St{St}]"
        kz, ke = rs.importance_sample(scfg, o, d, cache, t_rand, perm, eik)
        pz, pe = rs.importance_sample_plain(scfg, o, d, cache, t_rand, perm, eik)
        same = torch.equal(kz, pz) and torch.equal(ke, pe)
        ms = cuda_time(lambda: rs.importance_sample(scfg, o, d, cache, t_rand, perm, eik))
        pms = cuda_time(lambda: rs.importance_sample_plain(scfg, o, d, cache, t_rand, perm,
                                                          eik), iters=3, warmup=1)
        vox = touched_voxels(128, (o[:, None, :] + z_pre[..., None] * d[:, None, :])
                             .reshape(-1, 3))
        if not same:
            chk.failures.append(f"importance_sample{tag}: not bit for bit")
        _sampler_record(chk, f"importance_sample{tag}", kz, ke, pz, pe, z_pre, ms, pms, R,
                        nbytes(o, d, t_rand, perm, eik, kz, ke) + 4 * vox,
                        R * Ne * 40 + R * St * 40, f"{where}; bit for bit {same}")
        sdf = (o[:, None, :] + z_pre[..., None] * d[:, None, :]).norm(dim=-1) - 0.6
        dens = dens_ops.laplace_density(sdf, torch.tensor(0.0125, device=dev))
        ins = (scfg, z_pre, near, far, dens, perm, eik)
        kz, ke = rs.importance_sample_given(*ins)
        pz, pe = rs.importance_sample_given_plain(*ins)
        same = torch.equal(kz, pz) and torch.equal(ke, pe)
        ms = cuda_time(lambda: rs.importance_sample_given(*ins))
        pms = cuda_time(lambda: rs.importance_sample_given_plain(*ins), iters=3, warmup=1)
        if not same:
            chk.failures.append(f"importance_sample_given{tag}: not bit for bit")
        _sampler_record(chk, f"importance_sample_given{tag}", kz, ke, pz, pe, z_pre, ms, pms,
                        R, nbytes(*ins[1:], kz, ke), R * Ne * 20 + R * St * 40,
                        f"{where}; jittered z; bit for bit {same}")
        del ins, dens, sdf, t_rand, z_pre, kz, pz
        torch.cuda.empty_cache()


def check_limits(dev, chk: Checks):
    """Phase 3's cases past the kernels' old limits: K5 (LIMIT_SAMPLER), K4
    (LIMIT_COMPOSITE, LIMIT_TOPK), the general K6 (LIMIT_SDF_CASES, also
    no further from float64 than the plain version), each through its
    hand-written kernel."""
    check_sampler_limits(dev, chk)
    log(f"  on record for the shipped shapes: {RECORD_MS['K4']}")
    for S in LIMIT_COMPOSITE:
        check_demo_kernels(dev, chk, LIMIT_RAYS, S, f"[limit {LIMIT_RAYS}x{S}]")
    check_topk_kernels(dev, chk, cases=[(LIMIT_RAYS, S, Kc, "random",
                                         f"[limit {LIMIT_RAYS}x{S} Kc{Kc}]")
                                        for S, Kc in LIMIT_TOPK])
    log(f"  on record for the shipped shapes: {RECORD_MS['K6']}")
    check_sdf_general(dev, chk, LIMIT_SDF_CASES, strict=True)


def tsdf_frame(dev, H: int, W: int, yaw: float):
    """A depth frame inside a room of half-size 3 (the ray to the walls of
    the box [-3, 3]³ from a camera at (0.3, -0.2, 0.5)), its w2c and K, as
    float32 tensors on the card; 20 rows without depth."""
    import numpy as np
    import torch
    fx, fy, cx, cy = REPLICA_K
    c, s = np.cos(yaw), np.sin(yaw)
    c2w = np.eye(4)
    c2w[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    c2w[:3, 3] = [0.3, -0.2, 0.5]
    ys, xs = np.mgrid[0:H, 0:W]
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones((H, W))], -1)
    d_w = d_cam @ c2w[:3, :3].T
    with np.errstate(divide="ignore"):
        t = np.min(np.where(d_w != 0, (np.sign(d_w) * 3.0 - c2w[:3, 3]) / d_w, np.inf), -1)
    depth = t.astype(np.float32)
    depth[:20] = 0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return (torch.from_numpy(depth).to(dev),
            torch.from_numpy(np.linalg.inv(c2w).astype(np.float32)).to(dev),
            torch.from_numpy(K).to(dev))


def check_tsdf_kernel(dev, chk: Checks):
    """K9 against its plain version: one 680 x 1200 frame into a 256³ volume
    that already holds one frame; tsdf and weight must be equal bit for
    bit."""
    import torch
    from nicer_slam_tpu_torch.ops import tsdf as tsdf_ops
    p, res = PATHS["preprocess"], TSDF_RES
    coords = tsdf_ops.axis_coords(res, [-3.2] * 3, [3.2] * 3, dev)
    trunc = 4.0 * 6.4 / res
    tsdf = torch.ones(res ** 3, device=dev)
    weight = torch.zeros(res ** 3, device=dev)
    tsdf_ops.integrate_plain(tsdf, weight, *tsdf_frame(dev, p["H"], p["W"], 0.0), coords,
                             trunc, 5.0)
    frame = tsdf_frame(dev, p["H"], p["W"], 0.3)
    kt, kw, pt, pw = tsdf.clone(), weight.clone(), tsdf.clone(), weight.clone()
    tsdf_ops.integrate(kt, kw, *frame, coords, trunc, 5.0)
    _, pms = timed_once(lambda: tsdf_ops.integrate_plain(pt, pw, *frame, coords, trunc, 5.0))
    same = torch.equal(kt, pt) and torch.equal(kw, pw)
    err = max(max_abs(kt, pt), max_abs(kw, pw))
    # the plain version's masks: voxels this frame observes, and voxels with
    # a weight after it (the timed launches repeat the frame, so both stay)
    observed = int((pw != weight).sum())
    held = int((pw > 0).sum())
    ms = cuda_time(lambda: tsdf_ops.integrate(tsdf, weight, *frame, coords, trunc, 5.0))
    # what the function must move: every voxel's weight read, the tsdf of
    # each voxel with a weight read and written, the weight of each observed
    # voxel written, the depth frame and the coordinates read once; ~32
    # operations a voxel (the projection's 9 products and 9 sums, 2 products,
    # 2 divisions, 2 sums and 2 roundings for the pixel, the sdf, its
    # division and clamp, the weighted mean)
    small = nbytes(frame[0], *coords, frame[1], frame[2])
    bytes_ = 4 * res ** 3 + 8 * held + 4 * observed + small
    # the dense figure (both volumes read and written everywhere), for
    # comparison with the first kernel, which moved that
    dense_ms = bound(16 * res ** 3 + small, 0)[0]
    chk.record("tsdf.integrate", "nicer_slam_tpu_torch/csrc/tsdf.cu",
               "nicer_slam_tpu/preprocess/tsdf_fusion.py:33", err, same and observed > 0,
               ms, pms, bytes_, 32 * res ** 3,
               f"(256³ volume, 680x1200 frame, {observed} voxels observed, {held} with "
               f"a weight, bit for bit {same}; dense 16 B a voxel {dense_ms:.4f} ms; on "
               f"record: {RECORD_MS['K9']})")


def check_bf16_kernels(dev, chk: Checks):
    """K3 on both SDF grids, from tables rounded to bf16, at the three
    point orders of its launches; the plain version 3 times after 1."""
    import torch
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    specs = hash_specs()
    for grid in SDF_GRIDS:
        spec = specs[grid]
        table = torch.rand((spec.total_entries, spec.level_dim), generator=g, device=dev) * 2 - 1
        packed = he.pack_table_bf16(table)
        L, C = spec.num_levels, spec.level_dim
        for order in BF16_ORDERS:
            xp = bf16_points(g, dev, order)
            Np = xp.shape[0]
            ko = he.hash_encode_bf16(spec, packed, xp)
            po = he.hash_encode_bf16_plain(spec, packed, xp)
            ms = cuda_time(lambda: he.hash_encode_bf16(spec, packed, xp))
            pms = cuda_time(lambda: he.hash_encode_bf16_plain(spec, packed, xp), iters=3,
                            warmup=1)
            chk.values(f"hash_encode_bf16[{grid}/{order}]", "nicer_slam_tpu_torch/csrc/"
                       "hash_encoder.cu", "nicer_slam_tpu/ops/hash_encoder.py:858", [ko], [po],
                       ms, pms, (f"feats, bit-equal {bool(torch.equal(ko, po))}, {Np} points",),
                       nbytes(xp, ko) + touched_rows(spec, xp) * C * 2, 2 * C * 8 * L * Np)
            del ko, po, xp
        del table, packed
        torch.cuda.empty_cache()


# K2's backward on bf16 rows (the sharded colour encode's backward): the
# flagship's colour grid at the top-16 points of a flagship mapping
# iteration (8192 x 16) and at the demo's 4096 x 98, ray-ordered
BF16_BWD_CASES = ("top16", "demo")


def check_hash_bf16_bwd(dev, chk: Checks):
    """The sharded colour encode's backward kernel against its plain
    version (hash_encode_bf16_bwd_plain: autograd of the plain encode on
    the widened bf16 table): grad_x within K2's backward bound, the table
    gradient within it and the same bit for bit over 3 launches and equal
    to K2's (it does not depend on the table), the kept accumulator zero
    after each; the bound reads the touched rows in bf16."""
    import torch
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    spec = hash_specs()["color"]
    L, C = spec.num_levels, spec.level_dim
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    packed = he.pack_table_bf16(torch.rand((spec.total_entries, C), generator=g,
                                           device=dev) * 2 - 1)
    scratch = he.fixed_point_scratch(spec, dev)
    for kind in BF16_BWD_CASES:
        x = hash_points(g, dev, kind, "ray")
        N = x.shape[0]
        rows = touched_rows(spec, x)
        gf = torch.randn((N, L * C), generator=g, device=dev)
        g_table = torch.empty((spec.total_entries, C), device=dev)
        g_x = torch.empty((N, 3), device=dev)

        def bwd():
            he.hash_encode_bf16_bwd_launch(spec, packed, x, 1.0, gf, g_table, g_x)

        zero_after = []
        bwd()
        zero_after.append(he.fixed_point_state_is_zero(spec, scratch))
        (pgt, pgx), pms = timed_once(lambda: he.hash_encode_bf16_bwd_plain(spec, packed, x,
                                                                            gf))
        ex, et = rel_l2(g_x, pgx), rel_l2(g_table, pgt)
        err = max(max_abs(g_x, pgx), max_abs(g_table, pgt))
        del pgt, pgx
        first = g_table.clone()
        same = True
        for _ in range(2):
            bwd()
            zero_after.append(he.fixed_point_state_is_zero(spec, scratch))
            same &= torch.equal(first, g_table)
        # K2's backward on the float32 table: the same table gradient
        he.hash_encode_bwd_launch(spec, packed.to(torch.float32), x, 1.0, False, gf, None,
                                  g_table, None)
        as_k2 = torch.equal(first, g_table)
        del first
        ms = cuda_time(bwd)
        zero_after.append(he.fixed_point_state_is_zero(spec, scratch))
        nb, ops = hash_cost(spec, N, rows, False, True)
        # the touched rows read in bf16 (2 bytes a channel), not float32
        nb -= rows * C * 2
        floor_ms = hash_floor_ms(spec, N, rows, False) - rows * C * 2 / HBM_BYTES_PER_S * 1e3
        chk.record(f"hash_encode_bf16.bwd[color/{kind}/ray]",
                   "nicer_slam_tpu_torch/csrc/hash_encoder.cu",
                   "nicer_slam_tpu/ops/hash_encoder.py:759", err,
                   ex <= GRAD_REL_L2 and et <= GRAD_REL_L2 and same and as_k2
                   and all(zero_after), ms, pms, nb, ops,
                   f"(rel L2: grad_x {ex:.2e}, grad_table {et:.2e}; {N} points, {rows} rows; "
                   f"the same over 3 launches: {same}; K2's table gradient: {as_k2}; "
                   f"accumulator and bitmap zero after each of 3 launches and after the timed "
                   f"ones: {zero_after}; floor with the maxima pass and the dense g_table "
                   f"{floor_ms:.4f} ms)")
        del x, gf, g_table, g_x
        torch.cuda.empty_cache()
    del packed, scratch
    torch.cuda.empty_cache()


# rays that leave the cube behind their camera (the long run's held-out
# cameras from view 4 on stand outside the cube, and their rays, not of
# unit length, exit it up to 2.1 behind them; PERF.md section 6): a render
# chunk's 2580 unit rays in every direction from a camera 1.5 beyond the
# cube's face, 640 unjittered prepass z from near 0 to the cube's far,
# which is negative (at most -1.5) for the rays that point away from it
# and meet it behind; the fog's density 1 / (BETA_A + BETA_C) overflows
# the prepass transmittance where |far| > 88.72 (A + C)
BEHIND_ORIGIN = (2.5, -0.11, -0.89)


def check_behind_cube(dev, chk: Checks):
    """K6 ray mode, K5 given and K4's composite on rays with near > far
    against their plain versions: which entries are finite must agree, and
    the finite entries as in the other checks (K6 within SDF_DENSITY_RTOL
    of the largest density; K5's rays within Z_ATOL, sampler_agreement;
    K4 within VAL_RTOL of each output's largest)."""
    import torch
    from nicer_slam_tpu_torch.ops import density as dens_ops
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    from nicer_slam_tpu_torch.ops import sdf_density as sd
    from nicer_slam_tpu_torch.ops import volume_rendering as vr

    R = GIVEN_RAYS
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    d = torch.randn((R, 3), generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    o = torch.tensor(BEHIND_ORIGIN, device=dev).expand(R, 3).contiguous()
    scfg = rs.SamplerConfig(N_samples=64, N_samples_eval=640, N_samples_extra=32)
    z, near, far = rs.uniform_z_vals(scfg, o, d, None)
    behind = int((far < near).sum())
    sigma = 1.0 / (dens_ops.BETA_A + dens_ops.BETA_C)
    overflow = int((far[:, 0] * -sigma > 88.72).sum())

    def same_finite(a, b):
        return bool(torch.equal(torch.isfinite(a), torch.isfinite(b)))

    # K6, ray mode, on the flagship networks
    net, vox = sdf_net(dev)
    pack = sd.pack_sdf(net)
    ko = sd.density_rays(net, pack, o, d, z, vox)
    po = sd.density_rays_plain(net, pack.tables, o, d, z, vox)
    fin = torch.isfinite(po)
    err, scale = max_abs(ko[fin], po[fin]), float(po[fin].abs().max())
    ms = cuda_time(lambda: sd.density_rays(net, pack, o, d, z, vox))
    pms = cuda_time(lambda: sd.density_rays_plain(net, pack.tables, o, d, z, vox), iters=3,
                    warmup=1)
    chk.record(f"sdf_density.rays[behind {R}x640]", "nicer_slam_tpu_torch/csrc/sdf_density.cu",
               "nicer_slam_tpu/models/scene_model.py:246", err,
               same_finite(ko, po) and err <= SDF_DENSITY_RTOL * scale, ms, pms,
               *sdf_density_cost(z.numel(), nbytes(o, d, z, ko)),
               f"({behind} of {R} rays with far < near; finite entries agree: "
               f"{same_finite(ko, po)}, {int(fin.sum())} of {po.numel()})")
    del net, vox, pack, ko, po
    torch.cuda.empty_cache()
    # K5 given, the fog's density at every prepass sample
    dens = torch.full_like(z, sigma)
    perm = torch.linspace(0, 639, 32, device=dev).to(torch.int64)
    eik = torch.zeros((R,), dtype=torch.int64, device=dev)
    ins = (scfg, z, near, far, dens, perm, eik)
    kz, ke = rs.importance_sample_given(*ins)
    pz, pe = rs.importance_sample_given_plain(*ins)
    rows_ok = torch.isfinite(pz).all(1) & torch.isfinite(kz).all(1)
    a = sampler_agreement(kz[rows_ok], ke[rows_ok], pz[rows_ok], pe[rows_ok], z[rows_ok])
    nan_rows = int((~torch.isfinite(pz)).any(1).sum())
    ms = cuda_time(lambda: rs.importance_sample_given(*ins))
    pms = cuda_time(lambda: rs.importance_sample_given_plain(*ins))
    ok5 = same_finite(kz, pz) and same_finite(ke, pe) and a["ok"] and nan_rows > 0
    chk.record(f"importance_sample_given[behind {R}]", "nicer_slam_tpu_torch/csrc/sampler.cu",
               "nicer_slam_tpu/ops/ray_sampling.py:112", a["max_err"], ok5, ms, pms,
               nbytes(*ins[1:], kz, ke), R * 640 * 20 + R * kz.shape[1] * 40,
               f"(rays with a non-finite sample: {nan_rows}, predicted by the overflow "
               f"{overflow}; finite entries agree: z {same_finite(kz, pz)}, z_eik "
               f"{same_finite(ke, pe)}; finite rays off by more than {Z_ATOL:g}: "
               f"{a['n_off']}, at u = 1 alone {a['n_u1']})")
    # K4's composite on the plain version's samples, the fog's density
    S = pz.shape[1]
    zc, dc = pz.contiguous(), torch.full_like(pz, sigma)
    rgb = torch.rand((R, S, 3), generator=g, device=dev)
    nrm = torch.randn((R, S, 3), generator=g, device=dev)
    with torch.no_grad():
        ko, po = vr.composite(zc, dc, rgb, nrm), vr.composite_plain(zc, dc, rgb, nrm)
        ms = cuda_time(lambda: vr.composite(zc, dc, rgb, nrm))
        pms = cuda_time(lambda: vr.composite_plain(zc, dc, rgb, nrm))
    fin_ok = all(same_finite(k, p) for k, p in zip(ko, po))
    errs = [max_abs(k[torch.isfinite(p)], p[torch.isfinite(p)]) for k, p in zip(ko, po)]
    scales = [float(p[torch.isfinite(p)].abs().max()) for p in po]
    chk.record(f"composite.fwd[behind {R}x{S}]", "nicer_slam_tpu_torch/csrc/composite.cu",
               "nicer_slam_tpu/ops/volume_rendering.py:15", max(errs),
               fin_ok and all(e <= VAL_RTOL * sc for e, sc in zip(errs, scales)), ms, pms,
               nbytes(zc, dc, rgb, nrm, *ko), R * S * 30,
               f"(finite entries agree: {fin_ok}; rays with a non-finite colour: "
               f"{int((~torch.isfinite(po[1])).any(1).sum())})")


# K7's points: a flagship mapping iteration's 8192 x 98 samples, as the
# earlier kernel was timed (70 % on a thin shell around the surface they
# crowd to, the rest anywhere, a few outside; in no order) and ray-ordered
# as the path hands them over; a tracking iteration's 1024 x 98
# ray-ordered samples; a density-cache build chunk (131,072 grid points in
# the build's order)
VOXEL_CASES = (("shell", 8192 * 98), ("ray", 8192 * 98), ("ray", 1024 * 98),
               ("cache", 131072))


def voxel_points(g, dev, kind: str, n: int):
    import torch
    if kind == "ray":
        return ray_points(g, dev, n // 98, 98)
    if kind == "cache":
        return bf16_points(g, dev, "cache")
    u = torch.randn((n, 3), generator=g, device=dev)
    shell = u / u.norm(dim=-1, keepdim=True) * (
        0.6 + 0.02 * torch.randn((n, 1), generator=g, device=dev))
    anywhere = torch.rand((n, 3), generator=g, device=dev) * 2.1 - 1.05
    pick = torch.rand((n, 1), generator=g, device=dev) < 0.7
    return torch.where(pick, shell, anywhere).contiguous()


def check_voxel_kernels(dev, chk: Checks):
    """K7's scatter and β read at VOXEL_CASES: the counter bit for bit
    (and the input counter left as it was), β within VAL_RTOL."""
    import torch
    from nicer_slam_tpu_torch.ops import density as dens_ops

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    cu = "nicer_slam_tpu_torch/csrc/"
    for kind, n in VOXEL_CASES:
        x = voxel_points(g, dev, kind, n)
        N = x.shape[0]
        tag = f"[{kind} {N}]"
        vox0 = torch.randint(0, 200, (64, 64, 64), generator=g, device=dev).to(torch.float32)
        before = vox0.clone()
        kv = dens_ops.update_voxels(vox0, x)
        pv = dens_ops.update_voxels_plain(vox0, x)
        exact, kept = bool(torch.equal(kv, pv)), bool(torch.equal(vox0, before))
        ms = cuda_time(lambda: dens_ops.update_voxels(vox0, x))
        pms = cuda_time(lambda: dens_ops.update_voxels_plain(vox0, x))
        # the library call: one accumulating index_put_ of ones at the points'
        # voxels (indices computed outside the timed call)
        vidx, boundary = dens_ops._voxel_index(x, 64)
        flat = ((vidx[:, 0] * 64 + vidx[:, 1]) * 64 + vidx[:, 2])[~boundary]
        ones, counter = torch.ones_like(flat, dtype=torch.float32), vox0.clone().view(-1)
        lib_ms = cuda_time(lambda: counter.index_put_((flat,), ones, accumulate=True))
        touched = int(torch.unique(flat).numel())
        # x read, the counter copied and scattered into (read and written once)
        chk.record(f"voxels.scatter{tag}", cu + "voxels.cu",
                   "nicer_slam_tpu/ops/density.py:61", max_abs(kv, pv), exact and kept, ms,
                   pms, nbytes(x, vox0, kv), N * 12,
                   f"(counter bit for bit: {exact}; input unchanged: {kept}; {N} points, "
                   f"{flat.numel()} inside, {touched} voxels, largest count "
                   f"{float(pv.max()):g})", library_ms=lib_ms)
        kb = dens_ops.grid_predefined_beta(kv, x)
        pb = dens_ops.grid_predefined_beta_plain(kv, x)
        ms = cuda_time(lambda: dens_ops.grid_predefined_beta(kv, x))
        pms = cuda_time(lambda: dens_ops.grid_predefined_beta_plain(kv, x))
        # x read, the counter by the voxels these points read, beta written
        chk.values(f"voxels.beta{tag}", cu + "voxels.cu", "nicer_slam_tpu/ops/density.py:46",
                   [kb], [pb], ms, pms, (f"beta, {touched} voxels read",),
                   nbytes(x, kb) + 4 * touched, N * 20)
        del x, vox0, before, kv, pv, vidx, boundary, flat, ones, counter, kb, pb


# rays of the colour top-k launches on the flagship path: tracking (1000
# launches per run) and mapping (300)
TOPK_RAYS = (1024, 8192)


def surface_densities(g, dev, z, beta: float = 3e-3):
    """The Laplace density of an SDF that crosses zero at a random depth per
    ray (beta 3e-3): most weights are exact zeros or subnormals, and many
    rays have fewer than 16 non-zero weights, so the tie rule decides their
    last picks."""
    import torch
    from nicer_slam_tpu_torch.ops import density as dens_ops
    surf = 0.3 + 2.4 * torch.rand((z.shape[0], 1), generator=g, device=dev)
    return dens_ops.laplace_density(surf - z, torch.tensor(beta, device=dev)).contiguous()


# shapes the path does not give the top-k kernels, each holding other code
# of them: 200 samples (the weights pass and its backward at 32 rounds),
# Kc 40 (the backward's picks past the first 32, the colour composite's
# loop over chunks of 32) and Kc 12 (colour groups of 16 lanes, 4 idle)
TOPK_GENERAL = ((64, 200, 40), (64, 98, 12))


def check_topk_kernels(dev, chk: Checks, S: int = 98, Kc: int = 16, cases=None):
    """K4 with colour top-k at the flagship configuration's shapes: the
    weights pass forward and backward and the top-k colour composite at the
    tracking and mapping ray counts (random densities), and the weights
    pass on surface-like densities at 8192 rays; then all of them at the
    TOPK_GENERAL shapes. ``cases`` ((R, S, Kc, densities, tag), ...)
    replaces that list."""
    import torch
    from nicer_slam_tpu_torch.ops import volume_rendering as vr

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    src = "nicer_slam_tpu_torch/csrc/composite.cu"
    if cases is None:
        cases = ([(R, S, Kc, "random", f"[{R}]") for R in TOPK_RAYS]
                 + [(TOPK_RAYS[-1], S, Kc, "surface", f"[surface {TOPK_RAYS[-1]}]")]
                 + [(R, S_, K_, "random", f"[general {R}x{S_} Kc{K_}]")
                    for R, S_, K_ in TOPK_GENERAL])
    for R, S, Kc, kind, tag in cases:
        z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 3.0, dim=1)[0]
        dens = (torch.rand((R, S), generator=g, device=dev) * 20.0 if kind == "random"
                else surface_densities(g, dev, z))
        nrm = torch.randn((R, S, 3), generator=g, device=dev)
        with torch.no_grad():
            ko = vr.weights_topk(z, dens, nrm, Kc)
            po = vr.weights_topk_plain(z, dens, nrm, Kc)
            ms = cuda_time(lambda: vr.weights_topk(z, dens, nrm, Kc))
            pms = cuda_time(lambda: vr.weights_topk_plain(z, dens, nrm, Kc))
            lib_ms = cuda_time(lambda: torch.topk(po[0], Kc, dim=1))
        # the picks through the plain weights: equal values whatever order
        # ties take
        picked_k = po[0].reshape(-1)[ko[5].reshape(-1)].reshape(R, Kc)
        n_diff = int((ko[5] != po[5]).any(1).sum())
        sparse = int(((po[0] > 0).sum(1) < Kc).sum())
        chk.values(f"weights_topk.fwd{tag}", src, "nicer_slam_tpu/models/scene_model.py:321",
                   list(ko[:5]) + [picked_k], list(po[:5]) + [po[3]], ms, pms,
                   ("weights", "depth", "normal", "topk_w", "wsum",
                    f"picked plain weights ({n_diff} rays pick other indices; {sparse} "
                    f"rays with fewer than {Kc} non-zero weights; library = torch.topk, "
                    f"pick only)"),
                   nbytes(z, dens, nrm, *ko), R * S * (30 + Kc), library_ms=lib_ms)
        # the backward: autograd through the kernel's weights pass, cotangents
        # on all five outputs, against the closed form at the kernel's picks
        picks = ko[5]
        cots = [torch.randn(t.shape, generator=g, device=dev) for t in ko[:5]]
        gw, gdep, gn, gtw, gws = cots
        ins = [t.clone().requires_grad_(True) for t in (dens, nrm)]
        kg = torch.autograd.grad(vr.weights_topk(z, *ins, Kc)[:5], ins, cots)
        pg = vr.weights_topk_bwd_plain(z, dens, nrm, picks, *cots)
        errs = [rel_l2(a, b) for a, b in zip(kg, pg)]
        # the launch alone with the path's cotangents (nothing reads the
        # weights with a gradient: g_weights is None)
        ms = cuda_time(lambda: vr._composite_bwd("weights_topk.bwd", z, dens, None, nrm, None,
                                                 None, gdep, gn, picks, gtw, gws))
        pms = cuda_time(lambda: vr.weights_topk_bwd_plain(z, dens, nrm, picks, None, gdep, gn,
                                                          gtw, gws))
        chk.record(f"weights_topk.bwd{tag}", src, "nicer_slam_tpu/models/scene_model.py:321",
                   max(max_abs(a, b) for a, b in zip(kg, pg)), max(errs) <= GRAD_REL_L2,
                   ms, pms, nbytes(z, dens, nrm, gdep, gn, picks, gtw, gws, *kg), R * S * 50,
                   "(rel L2 density/normals " + "/".join(f"{e:.1e}" for e in errs)
                   + "; timed with the path's cotangents, g_weights None)")
        del kg, pg, ins, cots, gw
        if kind == "surface":
            continue
        topk_w, wsum = po[3].contiguous(), po[4].contiguous()
        rgb = torch.rand((R, Kc, 3), generator=g, device=dev)
        with torch.no_grad():
            ko = vr.topk_rgb(topk_w, wsum, rgb)
            po = vr.topk_rgb_plain(topk_w, wsum, rgb)
            ms = cuda_time(lambda: vr.topk_rgb(topk_w, wsum, rgb))
            pms = cuda_time(lambda: vr.topk_rgb_plain(topk_w, wsum, rgb))
        chk.values(f"topk_rgb.fwd{tag}", src, "nicer_slam_tpu/models/scene_model.py:338",
                   [ko], [po], ms, pms, ("rgb",), nbytes(topk_w, wsum, rgb, ko), R * Kc * 8)
        go = torch.randn((R, 3), generator=g, device=dev)
        ins_k = [t.clone().requires_grad_(True) for t in (topk_w, wsum, rgb)]
        ins_p = [t.clone().requires_grad_(True) for t in (topk_w, wsum, rgb)]
        kl = (vr.topk_rgb(*ins_k) * go).sum()
        pl = (vr.topk_rgb_plain(*ins_p) * go).sum()
        kg = torch.autograd.grad(kl, ins_k, retain_graph=True)
        pg = torch.autograd.grad(pl, ins_p, retain_graph=True)
        ms = cuda_time(lambda: vr._topk_rgb_bwd(topk_w, wsum, rgb, go))
        pms = cuda_time(lambda: torch.autograd.grad(pl, ins_p, retain_graph=True))
        chk.values(f"topk_rgb.bwd{tag}", src, "nicer_slam_tpu/models/scene_model.py:338",
                   kg, pg, ms, pms, ("g_topk_w", "g_wsum", "g_rgb"),
                   nbytes(topk_w, wsum, rgb, go, *kg), R * Kc * 12)


# ---------------------------------------------------------------------------
# phases 4-5: the SLAM main paths
# ---------------------------------------------------------------------------

def scene_dir(kind: str) -> str:
    if kind == "capture":
        return os.path.join(SMOKE_DIR, "capture", CAPTURE_SCENE)
    p = PATHS[kind]
    return os.path.join(SMOKE_DIR, f"Synthetic_{kind}_{p['H']}x{p['W']}")


def write_capture(scene: str) -> None:
    """A raw Replica-layout capture of the synthetic scene in world units
    (cube units x CAPTURE_SCALE), the tree the Replica converter reads:
    <root>/<scene>/{traj.txt, results/{frame%06d.jpg, depth%06d.png}} and
    <root>/<scene>_mesh.ply (tests/test_preprocess_e2e.py's capture, at
    Replica's size and camera)."""
    import cv2
    import numpy as np
    from nicer_slam_tpu_torch.datasets.synthetic import (camera_trajectory, render_frame,
                                                         scene_sdf)
    from nicer_slam_tpu_torch.ops.marching_cubes import extract_mesh
    from nicer_slam_tpu_torch.utils.ply import write_ply

    H, W = PATHS["preprocess"]["H"], PATHS["preprocess"]["W"]
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = REPLICA_K
    os.makedirs(os.path.join(scene, "results"))
    lines = []
    for i, c2w in enumerate(camera_trajectory(CAPTURE_FRAMES)):
        rgb, z, _, _ = render_frame(H, W, K, c2w)
        cv2.imwrite(os.path.join(scene, "results", f"frame{i:06d}.jpg"),
                    cv2.cvtColor((rgb * 255).astype(np.uint8), cv2.COLOR_RGB2BGR),
                    [int(cv2.IMWRITE_JPEG_QUALITY), 95])
        cv2.imwrite(os.path.join(scene, "results", f"depth{i:06d}.png"),
                    np.round(z * CAPTURE_SCALE * 6553.5).astype(np.uint16))
        cw = c2w.copy()
        cw[:3, 3] *= CAPTURE_SCALE
        lines.append(" ".join(f"{v:.9f}" for v in cw.reshape(-1)))
    with open(os.path.join(scene, "traj.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    verts, faces, normals = extract_mesh(scene_sdf, resolution=CAPTURE_MESH_RES,
                                         grid_boundary=(-1.0, 1.0))
    write_ply(os.path.join(os.path.dirname(scene), f"{CAPTURE_SCENE}_mesh.ply"),
              (verts * CAPTURE_SCALE).astype(np.float32), faces, normals=normals)


def write_scene(kind: str) -> None:
    """Generate one run's synthetic scan, and its held-out views where the
    run is evaluated, or the raw capture (run in a child process)."""
    from nicer_slam_tpu_torch.datasets.synthetic import generate, generate_eval
    if kind == "capture":
        shutil.rmtree(os.path.dirname(scene_dir(kind)), ignore_errors=True)
        write_capture(scene_dir(kind))
        open(os.path.join(scene_dir(kind), "complete"), "w").close()
        return
    p, data_dir = PATHS[kind], scene_dir(kind)
    shutil.rmtree(data_dir, ignore_errors=True)
    shutil.rmtree(data_dir + "_eval", ignore_errors=True)
    generate(data_dir, scan_id=p["scan_id"], n_frames=N_FRAMES, H=p["H"], W=p["W"],
             keyframe_every=10, with_flow=True)
    if p.get("eval_views"):
        generate_eval(data_dir, scan_id=p["scan_id"], n_views=p["eval_views"], H=p["H"],
                      W=p["W"])
    open(os.path.join(data_dir, "complete"), "w").close()


def start_scenes():
    """One child process per missing scan; returns {kind: Popen}."""
    procs = {}
    for kind in SCENES:
        if not os.path.exists(os.path.join(scene_dir(kind), "complete")):
            os.makedirs(SMOKE_DIR, exist_ok=True)
            procs[kind] = subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.write_scene({kind!r})"],
                cwd=ROOT)
    return procs


def wait_scene(procs, kind: str) -> str:
    if kind in procs:
        rc = procs[kind].wait()
        if rc != 0:
            raise RuntimeError(f"generating the {kind} scan failed ({rc})")
    return scene_dir(kind)


def write_conf(kind: str, data_dir: str, n_frames: int = N_FRAMES, tag: str = "") -> str:
    p = PATHS[kind]
    text = open(p["conf"]).read()
    edits = [(f"data_dir = {p['data_dir']}", f'data_dir = "{data_dir}"'),
             (f"n_images = {p['n_images']}", f"n_images = {n_frames}"),
             ("mapping_every_frame = 5\n", "mapping_every_frame = 5\n"
              f"        global_window_start = {GLOBAL_WINDOW_START}\n"),
             ("resolution = 512", f"resolution = {MESH_RESOLUTION}")] + p["edits"]
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{kind} conf edit failed ({old!r})")
        text = text.replace(old, new)
    if f"img_res = [\n        {p['H']}\n        {p['W']}\n    ]" not in text:
        raise RuntimeError(f"{kind} conf: unexpected img_res")
    path = os.path.join(SMOKE_DIR, f"{kind}_{n_frames}{tag}_smoke.conf")
    with open(path, "w") as f:
        f.write(text)
    return path


def run_slam(dev, kind: str, data_dir: str):
    import numpy as np
    import torch
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.training import exp_runner

    conf = write_conf(kind, data_dir)
    exps = os.path.join(SMOKE_DIR, f"exps_{kind}")
    shutil.rmtree(exps, ignore_errors=True)
    map_terms, flow_edges = {}, {}

    def hook(runner, frame_idx):
        if frame_idx % runner.mapping_every_frame == 0:
            map_terms[frame_idx] = runner.last_map_terms
            edges = runner._edge_refs
            flow_edges[frame_idx] = 0 if edges is None else int(edges[0].numel())

    # the CLI entry point, as a user runs it; counts and peak memory cover
    # set-up (model init, first density cache), the 11 frames and the vis hook
    argv = ["--conf", conf, "--root_dir", SMOKE_DIR, "--exps_folder", f"exps_{kind}",
            "--device", str(dev)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_launch_counts()
    t_run = time.perf_counter()
    runner = exp_runner.main(argv, frame_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    errs = {i: float(np.linalg.norm(runner.est_pose_all[i][:3, 3]
                                    - runner.dataset.gt_pose_all[i][:3, 3]))
            for i in range(N_FRAMES)}
    summ = runner.timer.summary()
    # the runner's phases are disjoint: tracking = track_frame, mapping =
    # map_step, cache = density-cache builds, frames = loading + staging a
    # frame, checkpoint = the npz writes, vis = the vis hook; "other" is the
    # rest of the loop. s/frame leaves out the one vis call after the loop.
    phase_s = {k: v["total_s"] for k, v in summ.items()}
    stats = {
        "setup_s": wall - runner.run_s,
        "s_per_frame": (runner.run_s - phase_s.get("vis", 0.0)) / N_FRAMES,
        "ms_per_track_iter": 1000 * phase_s["tracking"]
        / (summ["tracking"]["count"] * runner.num_cam_iters),
        "ms_per_map_iter": summ["mapping"]["mean_ms"],
        "cache_builds": summ["cache"]["count"],
        "ms_per_cache_build": summ["cache"]["mean_ms"],
        **{f"{k}_s": v for k, v in phase_s.items()},
        "other_s": runner.run_s - sum(phase_s.values()),
        "peak_mem_GiB": peak / 2 ** 30,
    }
    # the run's own outputs: the final model checkpoint holds the model, and
    # vis/ holds the panels and the mesh
    from nicer_slam_tpu_torch.slam.checkpoint import params_to_numpy
    ck = runner.checkpoints_path
    for sub in ("ModelParameters", "OptimizerParameters", "PoseParameters"):
        if not os.path.exists(os.path.join(ck, sub, "latest.npz")):
            raise RuntimeError(f"missing checkpoint {sub}")
    with np.load(os.path.join(ck, "ModelParameters", "latest.npz")) as saved:
        for k, v in params_to_numpy(runner.model).items():
            if not np.array_equal(saved["model_state_dict/" + k], v):
                raise RuntimeError(f"checkpoint differs from the model at {k}")
    vis = sorted(os.listdir(runner.plots_dir))
    return dict(runner=runner, map_terms=map_terms, flow_edges=flow_edges, errs=errs,
                counts=counts, stats=stats, vis=vis)


# the repeat phase: the demo path's first frames (mapping at 0 and 5), twice
REPEAT_FRAMES = 6


def repeat_once(dev, data_dir: str, tag: str) -> dict:
    """The demo configuration for REPEAT_FRAMES frames through the
    runner's own loop (no checkpoint writes, no vis hook): the per-frame
    poses, the last loss terms of each mapping call, and the final model
    and voxel tensors (on the card)."""
    import numpy as np
    from nicer_slam_tpu_torch.slam import runner as runner_mod

    r = runner_mod.SLAMRunner(conf=write_conf("demo", data_dir, REPEAT_FRAMES),
                              root_dir=SMOKE_DIR, exps_folder_name=f"exps_repeat_{tag}",
                              quiet=True, device=str(dev))
    terms = {}
    for f in range(r.n_images):
        r._stage_frame(f)
        r.track(f)
        if f % r.mapping_every_frame == 0:
            terms[f] = {k: v.detach().clone() for k, v in r.map(f).items()}
    state = {k: v.detach().clone() for k, v in r.model.state_dict().items()}
    state["voxels"] = r.voxels.detach().clone()
    return dict(poses={f: np.array(r.est_pose_all[f]) for f in range(r.n_images)},
                terms=terms, state=state)


def same_bits(a, b) -> bool:
    """Two tensors or arrays equal bit for bit (NaNs included)."""
    import numpy as np
    import torch
    if isinstance(a, torch.Tensor):
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def check_repeat(dev, data_dir: str, failures) -> None:
    """Runs repeat_once twice in this process; every pose, loss term,
    model tensor and the voxel counter must come out the same bit for
    bit."""
    import torch
    runs = []
    for i in range(2):
        t = time.perf_counter()
        runs.append(repeat_once(dev, data_dir, str(i)))
        log(f"  run {i}: {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()
    a, b = runs
    diff = [f"pose {f}" for f in a["poses"] if not same_bits(a["poses"][f], b["poses"][f])]
    diff += [f"frame-{f} {k}" for f in a["terms"] for k in a["terms"][f]
             if not same_bits(a["terms"][f][k], b["terms"][f][k])]
    diff += [k for k in a["state"] if not same_bits(a["state"][k], b["state"][k])]
    n = len(a["poses"]) + sum(map(len, a["terms"].values())) + len(a["state"])
    for f, terms in a["terms"].items():
        log(f"  frame-{f} mapping call, run 0: "
            + " ".join(f"{k}={float(v):.9g}" for k, v in terms.items()))
    log(f"  {n - len(diff)} of {n} compared values the same bit for bit "
        f"({len(a['poses'])} poses, {sum(map(len, a['terms'].values()))} loss terms, "
        f"{len(a['state'])} model and voxel tensors)" + (f"; differ: {diff}" if diff else ""))
    if diff:
        failures.append(f"repeat: two runs of the demo path differ at {diff}")


def report(kind: str, r, failures) -> None:
    import torch
    from nicer_slam_tpu_torch.utils.ply import read_ply

    log("  translation error vs GT per frame: "
        + " ".join(f"{i}:{e:.4f}" for i, e in r["errs"].items()))
    for f, terms in r["map_terms"].items():
        log(f"  loss terms, last iteration of the frame-{f} mapping call "
            f"({r['flow_edges'][f]} flow edges): "
            + " ".join(f"{k}={float(v):.5g}" for k, v in terms.items()))
    log("  launches: " + " ".join(f"{k}={v}" for k, v in r["counts"].items()))
    log("  " + " ".join(f"{k}={v:.4g}" for k, v in r["stats"].items()))
    log(f"  vis/: {' '.join(r['vis'])}")
    bad = [(f, k) for f, terms in r["map_terms"].items() for k, v in terms.items()
           if not torch.isfinite(v).all()]
    if bad:
        failures.append(f"{kind}: non-finite loss terms {bad}")
    if not all(map(lambda e: e == e and e < 1e3, r["errs"].values())):
        failures.append(f"{kind}: non-finite poses")
    last = max(r["map_terms"])
    terms = r["map_terms"][last]
    if r["flow_edges"][last] == 0 or not float(terms["flow_loss"]) > 0:
        failures.append(f"{kind}: the frame-{last} mapping call ran without live flow edges")
    if kind == "flagship" and not (torch.isfinite(terms["warp_loss"])
                                   and float(terms["warp_loss"]) > 0):
        failures.append(f"{kind}: warp_loss of the frame-{last} mapping call is "
                        f"{float(terms['warp_loss'])}, not finite and positive")
    # the cache builds and the vis render's exact prepass run K6, not K3
    counts, builds = r["counts"], r["stats"]["cache_builds"]
    log(f"  sdf_density launches: grid {counts['sdf_density.grid']} ({builds + 1} cache "
        f"builds, one at set-up), rays {counts['sdf_density.rays']} (render chunks); "
        f"hash_encode_bf16 launches {counts['hash_encode_bf16']}")
    if counts["hash_encode_bf16"] or counts["sdf_density.grid"] < builds:
        failures.append(f"{kind}: K3 launched on the main path, or fewer K6 grid launches "
                        f"than cache builds")
    never = [k for k in PATH_KERNELS[kind] if r["counts"][k] == 0]
    if never:
        failures.append(f"{kind}: kernels never launched on the main path: {never}")
    pngs = [v for v in r["vis"] if v.startswith("rendering_") and v.endswith(".png")]
    plys = [v for v in r["vis"] if v.startswith("surface_") and v.endswith(".ply")]
    if not pngs or not plys:
        failures.append(f"{kind}: vis/ holds no rendering_*.png or no surface_*.ply")
    else:
        mesh = read_ply(os.path.join(r["runner"].plots_dir, plys[-1]))
        log(f"  mesh {plys[-1]}: {len(mesh['verts'])} vertices, {len(mesh['faces'])} faces")


# ---------------------------------------------------------------------------
# phase 5b: the model options (the exact prepass in training, warp patches
# with SSIM, exposure; the nerf colour mode with per-image codes)
# ---------------------------------------------------------------------------

def run_counted(dev, conf: str, exps: str, n: int) -> dict:
    """exp_runner.main on conf for n frames, the launch counters reset
    before it and read after its last frame (the loop) and after its vis
    hook (the path); per mapping frame the last iteration's loss terms."""
    import numpy as np
    import torch
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.training import exp_runner

    map_terms, loop_counts = {}, {}

    def hook(runner, frame_idx):
        if frame_idx % runner.mapping_every_frame == 0:
            map_terms[frame_idx] = runner.last_map_terms
        if frame_idx == runner.n_images - 1:
            loop_counts.update(_cuda.launch_counts())

    shutil.rmtree(os.path.join(SMOKE_DIR, exps), ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_launch_counts()
    t = time.perf_counter()
    runner = exp_runner.main(["--conf", conf, "--root_dir", SMOKE_DIR, "--exps_folder", exps,
                              "--device", str(dev)], frame_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    summ = runner.timer.summary()
    phase_s = {k: v["total_s"] for k, v in summ.items()}
    errs = [float(np.linalg.norm(runner.est_pose_all[i][:3, 3]
                                 - runner.dataset.gt_pose_all[i][:3, 3])) for i in range(n)]
    return dict(runner=runner, counts=_cuda.launch_counts(), loop_counts=loop_counts,
                map_terms=map_terms, errs=errs,
                iters=summ["tracking"]["count"] * runner.num_cam_iters
                + summ["mapping"]["count"],
                stats={"setup_s": wall - runner.run_s,
                       "s_per_frame": (runner.run_s - phase_s.get("vis", 0.0)) / n,
                       "ms_per_track_iter": 1000 * phase_s["tracking"]
                       / (summ["tracking"]["count"] * runner.num_cam_iters),
                       "ms_per_map_iter": summ["mapping"]["mean_ms"],
                       **{f"{k}_s": v for k, v in phase_s.items()},
                       "peak_mem_GiB": torch.cuda.max_memory_allocated(dev) / 2 ** 30})


def run_options(dev, flagship_dir: str, demo_dir: str) -> dict:
    """The options conf through exp_runner for OPTIONS_FRAMES frames
    (``run_counted``: its loop's and its path's launches); then the nerf
    conf for NERF_FRAMES frames (counted into the path). Returns what
    report_options reads."""
    import numpy as np
    import torch
    from nicer_slam_tpu_torch.models import scene_model as sm

    out = {}
    for kind, n in (("options", OPTIONS_FRAMES), ("nerf", NERF_FRAMES)):
        r = run_counted(dev, write_conf(kind, flagship_dir if kind == "options" else demo_dir,
                                        n), f"exps_{kind}", n)
        runner = r.pop("runner")
        r.update(vis=sorted(os.listdir(runner.plots_dir)),
                 cache=runner.density_cache is not None)
        if kind == "nerf":
            fresh = sm.SceneModel(runner.scene_cfg, np.random.default_rng(0)).render.embeddings
            r["codes_same"] = same_bits(runner.model.render.embeddings, fresh)
            r["codes_shape"] = tuple(fresh.shape)
        out[kind] = r
        del runner
        torch.cuda.empty_cache()
    out["counts"] = {k: out["options"]["counts"][k] + out["nerf"]["counts"][k]
                     for k in out["options"]["counts"]}
    return out


def report_options(o: dict, failures) -> None:
    import torch
    opt, nerf = o["options"], o["nerf"]
    for kind, r in (("options", opt), ("nerf", nerf)):
        log(f"  {kind}: translation error vs GT per frame: "
            + " ".join(f"{i}:{e:.4f}" for i, e in enumerate(r["errs"])))
        log("  " + " ".join(f"{k}={v:.4g}" for k, v in r["stats"].items()))
        log(f"  launches: " + " ".join(f"{k}={v}" for k, v in r["counts"].items() if v))
        log(f"  vis/: {' '.join(r['vis'])}")
        if not all(e == e and e < 1e3 for e in r["errs"]):
            failures.append(f"{kind}: non-finite poses")
    for f, terms in opt["map_terms"].items():
        log(f"  loss terms, last iteration of the frame-{f} mapping call: "
            + " ".join(f"{k}={float(v):.5g}" for k, v in terms.items()))
    bad = [(f, k) for f, terms in opt["map_terms"].items() for k, v in terms.items()
           if not torch.isfinite(v).all()]
    if bad:
        failures.append(f"options: non-finite loss terms {bad}")
    last = max(opt["map_terms"])
    warp = float(opt["map_terms"][last]["warp_loss"])
    if not warp > 0 or last != OPTIONS_FRAMES - 1:
        failures.append(f"options: warp_loss of the frame-{last} mapping call is {warp}")
    lc, iters = opt["loop_counts"], opt["iters"]
    log(f"  the loop ({iters} tracking and mapping iterations): sdf_density.rays "
        f"{lc['sdf_density.rays']}, sdf_density.grid {lc['sdf_density.grid']}, "
        f"importance_sample_given {lc['importance_sample_given']}, importance_sample "
        f"{lc['importance_sample']}; a density cache: {opt['cache']}")
    if (lc["sdf_density.grid"] or lc["importance_sample"] or opt["cache"]
            or lc["sdf_density.rays"] != iters or lc["importance_sample_given"] != iters):
        failures.append(f"options: the loop's exact prepass launched K6 rays "
                        f"{lc['sdf_density.rays']} and K5 given {lc['importance_sample_given']} "
                        f"times for {iters} iterations, K6 grid {lc['sdf_density.grid']}, K5 "
                        f"cached {lc['importance_sample']} (a cache: {opt['cache']})")
    never = [k for k in PATH_KERNELS["options"] if lc[k] == 0]
    if never:
        failures.append(f"options: kernels never launched in the loop: {never}")
    log(f"  nerf: per-image codes {nerf['codes_shape']} the same bit for bit after "
        f"{NERF_FRAMES} frames: {nerf['codes_same']}")
    if not nerf["codes_same"]:
        failures.append("nerf: the frozen per-image codes changed")


# ---------------------------------------------------------------------------
# phase 5c: SDF networks beyond the shipped one (the general K6 and its
# concat variant through exp_runner), Adam in the optax layout on the card,
# and the training tools
# ---------------------------------------------------------------------------

def adam_round_trip(runner) -> dict:
    """The runner's Adam state saved in the optax layout and loaded into a
    fresh optimizer over a copy of its model: every moment and count must
    come back bit for bit, and one more step on the same gradients must
    leave both models and states the same bit for bit."""
    import copy
    import torch
    from nicer_slam_tpu_torch.slam import checkpoint as ckpt
    from nicer_slam_tpu_torch.slam import state as st

    path = os.path.join(SMOKE_DIR, "adam")
    shutil.rmtree(path, ignore_errors=True)
    model_a, opt_a = runner.model, runner.optimizer
    t = time.perf_counter()
    ckpt.save_optimizer(path, model_a, opt_a, runner.n_images - 1)
    save_s = time.perf_counter() - t
    model_b = copy.deepcopy(model_a)
    opt_b = st.make_optimizer(runner.optim_cfg, model_b)
    t = time.perf_counter()
    ckpt.load_optimizer(path, model_b, opt_b)
    load_s = time.perf_counter() - t

    def states_equal():
        pairs = list(zip(model_a.parameters(), model_b.parameters()))
        n = sum(1 for pa, _ in pairs if pa in opt_a.state)
        same = all((pa in opt_a.state) == (pb in opt_b.state)
                   and all(torch.equal(opt_a.state[pa][k], opt_b.state[pb][k])
                           for k in opt_a.state.get(pa, {}))
                   for pa, pb in pairs)
        return same, n

    loaded_same, n_states = states_equal()
    g = torch.Generator(device=next(model_a.parameters()).device)
    g.manual_seed(11)
    for pa, pb in zip(model_a.parameters(), model_b.parameters()):
        if pa.requires_grad:
            pa.grad = torch.randn(pa.shape, generator=g, device=pa.device) * 1e-3
            pb.grad = pa.grad.clone()
    opt_a.step()
    opt_b.step()
    stepped_same = (all(torch.equal(pa, pb) for pa, pb in zip(model_a.parameters(),
                                                             model_b.parameters()))
                    and states_equal()[0])
    steps = sorted({int(s["step"]) for s in opt_b.state.values()})
    del model_b, opt_b
    return dict(loaded_same=loaded_same, stepped_same=stepped_same, n_states=n_states,
                steps=steps, save_s=save_s, load_s=load_s,
                file_MB=os.path.getsize(os.path.join(path, "latest.npz")) / 1e6)


def run_networks(dev, flagship_dir: str) -> dict:
    """Phase 5c: TINY_CONF's networks on a small scan and the flagship conf
    with concat_coarse_feature, both with the exact prepass, through
    exp_runner; the Adam round trip on the concat run's optimizer;
    pretrain on the flagship networks, its npz into the port's runner; and
    train_mono_prior, its npz into the port's mono prior."""
    import numpy as np
    import torch
    from nicer_slam_tpu_torch.datasets.synthetic import generate
    from nicer_slam_tpu_torch.models.mono_prior import MonoPriorInference
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.slam.runner import SLAMRunner
    from nicer_slam_tpu_torch.training import pretrain, train_mono_prior

    out = {}
    tiny_dir = os.path.join(SMOKE_DIR, "tiny", "Synthetic")
    shutil.rmtree(os.path.dirname(tiny_dir), ignore_errors=True)
    generate(tiny_dir, scan_id=1, n_frames=TINY_FRAMES, H=TINY_H, W=TINY_W, world_scale=3.0,
             keyframe_every=10, with_flow=True)
    conf = os.path.join(SMOKE_DIR, "tiny.conf")
    with open(conf, "w") as f:
        f.write(TINY_CONF.format(data_dir=tiny_dir, H=TINY_H, W=TINY_W, n_images=TINY_FRAMES,
                                 map_iters=TINY_ITERS, track_iters=TINY_ITERS))
    out["tiny"] = run_counted(dev, conf, "exps_tiny", TINY_FRAMES)
    del out["tiny"]["runner"]
    # the same networks with the density cache: the general kernel's grid
    # mode builds it
    text = open(conf).read()
    cached = os.path.join(SMOKE_DIR, "tiny_cached.conf")
    with open(cached, "w") as f:
        f.write(text.replace("N_samples_extra = 8 }",
                             "N_samples_extra = 8  prepass_mode = cached }"))
    out["tiny_cached"] = run_counted(dev, cached, "exps_tiny_cached", TINY_CACHED_FRAMES)
    del out["tiny_cached"]["runner"]
    # a 20-layer fine network, past the general kernel's old 16 layers
    deep = os.path.join(SMOKE_DIR, "tiny_deep.conf")
    if text.count("d_in = 3  d_out = 1  dims = [ 32 32 ]") != 1:
        raise RuntimeError("TINY_CONF: no fine dims to deepen")
    with open(deep, "w") as f:
        f.write(text.replace("d_in = 3  d_out = 1  dims = [ 32 32 ]", TINY_DEEP_FINE))
    out["tiny_deep"] = run_counted(dev, deep, "exps_tiny_deep", TINY_DEEP_FRAMES)
    runner = out["tiny_deep"].pop("runner")
    out["tiny_deep"]["fine_layers"] = len(runner.model.implicit.fine.lins)
    del runner
    torch.cuda.empty_cache()

    out["concat"] = run_counted(dev, write_conf("concat", flagship_dir, CONCAT_FRAMES),
                                "exps_concat", CONCAT_FRAMES)
    runner = out["concat"].pop("runner")
    out["concat"]["concat"] = runner.scene_cfg.combine.fine.concat_coarse_feature
    out["adam"] = adam_round_trip(runner)
    del runner
    torch.cuda.empty_cache()

    pt_out = os.path.join(SMOKE_DIR, "pretrain_smoke.npz")
    _cuda.reset_launch_counts()
    t = time.perf_counter()
    hist = pretrain.train(steps=PRETRAIN_STEPS, conf=PATHS["flagship"]["conf"], out=pt_out,
                          device=dev, log_every=10)
    torch.cuda.synchronize()
    out["pretrain"] = dict(losses=[h["loss"] for h in hist], s=time.perf_counter() - t,
                           counts=_cuda.launch_counts())
    text = open(write_conf("flagship", flagship_dir, 2)).read()
    if text.count("train {\n") != 1:
        raise RuntimeError("flagship conf: no train block")
    conf = os.path.join(SMOKE_DIR, "pretrain_load.conf")
    with open(conf, "w") as f:
        f.write(text.replace("train {\n", f'train {{\n    pretrain_path = "{pt_out}"\n'))
    r = SLAMRunner(conf=conf, root_dir=SMOKE_DIR, exps_folder_name="exps_pretrain_load",
                   quiet=True, device=dev)
    with np.load(pt_out) as data:
        out["pretrain"]["loaded"] = all(
            np.array_equal(p.detach().cpu().numpy(), data[f"fine_lin{i}_{k}"])
            for i, lin in enumerate(r.model.implicit.fine.lins)
            for k, p in lin.named_parameters())
    del r
    torch.cuda.empty_cache()

    mp_out = os.path.join(SMOKE_DIR, "mono_prior_smoke.npz")
    t = time.perf_counter()
    hist = train_mono_prior.train(steps=MONO_STEPS, n_scenes=MONO_SCENES,
                                  frames_per_scene=MONO_FRAMES, out=mp_out, device=dev)
    torch.cuda.synchronize()
    d, n01 = MonoPriorInference(mp_out, device=dev)(
        np.random.default_rng(0).uniform(0, 1, (96, 128, 3)).astype(np.float32))
    out["mono"] = dict(losses=[h["loss"] for h in hist], s=time.perf_counter() - t,
                       cue_finite=bool(np.isfinite(d).all() and np.isfinite(n01).all()))
    out["counts"] = {k: sum(out[r]["counts"][k] for r in ("tiny", "tiny_cached", "tiny_deep",
                                                          "concat", "pretrain"))
                     for k in out["tiny"]["counts"]}
    return out


def _falls(losses) -> bool:
    import numpy as np
    head, tail = losses[:TOOL_WINDOW], losses[-TOOL_WINDOW:]
    return bool(np.isfinite(losses).all()) and sum(tail) / len(tail) < sum(head) / len(head)


def report_networks(nw: dict, failures) -> None:
    import torch
    for kind in ("tiny", "tiny_cached", "tiny_deep", "concat"):
        r = nw[kind]
        log(f"  {kind}: translation error vs GT per frame: "
            + " ".join(f"{i}:{e:.4f}" for i, e in enumerate(r["errs"])))
        log("  " + " ".join(f"{k}={v:.4g}" for k, v in r["stats"].items()))
        log("  launches: " + " ".join(f"{k}={v}" for k, v in r["counts"].items() if v))
        for f, terms in r["map_terms"].items():
            log(f"  loss terms, last iteration of the frame-{f} mapping call: "
                + " ".join(f"{k}={float(v):.5g}" for k, v in terms.items()))
        if not all(e == e and e < 1e3 for e in r["errs"]):
            failures.append(f"{kind}: non-finite poses")
        bad = [(f, k) for f, terms in r["map_terms"].items() for k, v in terms.items()
               if not torch.isfinite(v).all()]
        if bad or not r["map_terms"]:
            failures.append(f"{kind}: non-finite loss terms {bad} (or no mapping call)")
    tc, lc = nw["tiny"]["counts"], nw["concat"]["loop_counts"]
    log(f"  tiny: sdf_density_general.rays {tc['sdf_density_general.rays']}, the shipped "
        f"kernel {tc['sdf_density.rays'] + tc['sdf_density.grid']}")
    if tc["sdf_density_general.rays"] == 0 or tc["sdf_density.rays"] or tc["sdf_density.grid"]:
        failures.append("tiny: the general K6 did not run the exact prepass")
    dc = nw["tiny_deep"]["counts"]
    log(f"  tiny, deep ({nw['tiny_deep']['fine_layers']} fine layers): "
        f"sdf_density_general.rays {dc['sdf_density_general.rays']}")
    if dc["sdf_density_general.rays"] == 0 or nw["tiny_deep"]["fine_layers"] != 20:
        failures.append("tiny, deep: the 20-layer network did not run the general K6")
    cc = nw["tiny_cached"]["counts"]
    log(f"  tiny, cached: sdf_density_general.grid {cc['sdf_density_general.grid']} (cache "
        f"builds), importance_sample {cc['importance_sample']}, the shipped kernel "
        f"{cc['sdf_density.rays'] + cc['sdf_density.grid']}")
    if (cc["sdf_density_general.grid"] == 0 or cc["importance_sample"] == 0
            or cc["sdf_density.rays"] or cc["sdf_density.grid"]):
        failures.append("tiny, cached: the general K6 did not build the density cache")
    iters = nw["concat"]["iters"]
    log(f"  concat: the loop ({iters} tracking and mapping iterations): "
        f"sdf_density_concat.rays {lc['sdf_density_concat.rays']}, general "
        f"{lc['sdf_density_general.rays']}, shipped {lc['sdf_density.rays']} / "
        f"{lc['sdf_density.grid']}; concat_coarse_feature {nw['concat']['concat']}")
    if (not nw["concat"]["concat"] or lc["sdf_density_concat.rays"] != iters
            or lc["sdf_density.rays"] or lc["sdf_density.grid"]):
        failures.append(f"concat: K6-concat launched {lc['sdf_density_concat.rays']} times "
                        f"for {iters} iterations")
    a = nw["adam"]
    log(f"  adam (the concat run's optimizer, optax layout, {a['file_MB']:.1f} MB, save "
        f"{a['save_s']:.2f} s, load {a['load_s']:.2f} s): {a['n_states']} parameter states "
        f"loaded bit for bit: {a['loaded_same']}; the next step on the same gradients bit "
        f"for bit: {a['stepped_same']}; counts after it {a['steps']}")
    if not (a["loaded_same"] and a["stepped_same"] and a["n_states"] > 0):
        failures.append("adam: the optax-layout round trip is not bit for bit")
    pt = nw["pretrain"]
    k1 = (pt["counts"]["hash_encode_with_grad.fwd"], pt["counts"]["hash_encode_with_grad.bwd"])
    log(f"  pretrain ({PRETRAIN_STEPS} steps, {pt['s']:.2f} s): loss "
        f"{pt['losses'][0]:.5g} -> {pt['losses'][-1]:.5g} (means of the first and last "
        f"{TOOL_WINDOW}: {sum(pt['losses'][:TOOL_WINDOW]) / TOOL_WINDOW:.5g} -> "
        f"{sum(pt['losses'][-TOOL_WINDOW:]) / TOOL_WINDOW:.5g}); K1 fwd / bwd launches "
        f"{k1[0]} / {k1[1]}; loaded into the runner's fine MLP: {pt['loaded']}")
    if not (_falls(pt["losses"]) and min(k1) > 0 and pt["loaded"]):
        failures.append("pretrain: the loss did not fall, K1 never launched, or the npz did "
                        "not load")
    mo = nw["mono"]
    log(f"  train_mono_prior ({MONO_STEPS} steps, {MONO_SCENES * MONO_FRAMES} frames, "
        f"{mo['s']:.2f} s): loss {mo['losses'][0]:.5g} -> {mo['losses'][-1]:.5g} (means "
        f"{sum(mo['losses'][:TOOL_WINDOW]) / TOOL_WINDOW:.5g} -> "
        f"{sum(mo['losses'][-TOOL_WINDOW:]) / TOOL_WINDOW:.5g}); its cues finite: "
        f"{mo['cue_finite']}")
    if not (_falls(mo["losses"]) and mo["cue_finite"]):
        failures.append("train_mono_prior: the loss is not finite or did not fall")


# ---------------------------------------------------------------------------
# phase 5e: the demo configuration past the kernels' old sampler limits
# ---------------------------------------------------------------------------

def run_limits(dev, demo_dir: str) -> dict:
    """The limits conf (the demo at 720 x 1280 with 1280 prepass samples and
    128 + 64 + 2 samples a ray) through exp_runner for LIMITS_FRAMES
    frames."""
    r = run_counted(dev, write_conf("limits", demo_dir, LIMITS_FRAMES), "exps_limits",
                    LIMITS_FRAMES)
    runner = r.pop("runner")
    sc = runner.scene_cfg.sampler
    r.update(vis=sorted(os.listdir(runner.plots_dir)),
             sampler=(sc.N_samples_eval, sc.N_samples, sc.N_samples_extra))
    return r


def report_limits(r: dict, failures) -> None:
    import torch
    log(f"  sampler (N_samples_eval, N_samples, N_samples_extra) {r['sampler']}; "
        f"translation error vs GT per frame: "
        + " ".join(f"{i}:{e:.4f}" for i, e in enumerate(r["errs"])))
    log("  " + " ".join(f"{k}={v:.4g}" for k, v in r["stats"].items()))
    log("  launches: " + " ".join(f"{k}={v}" for k, v in r["counts"].items() if v))
    for f, terms in r["map_terms"].items():
        log(f"  loss terms, last iteration of the frame-{f} mapping call: "
            + " ".join(f"{k}={float(v):.5g}" for k, v in terms.items()))
    log(f"  vis/: {' '.join(r['vis'])}")
    if r["sampler"] != (1280, 128, 64):
        failures.append(f"limits: the run's sampler is {r['sampler']}")
    if not all(e == e and e < 1e3 for e in r["errs"]):
        failures.append("limits: non-finite poses")
    bad = [(f, k) for f, terms in r["map_terms"].items() for k, v in terms.items()
           if not torch.isfinite(v).all()]
    if bad or not r["map_terms"]:
        failures.append(f"limits: non-finite loss terms {bad} (or no mapping call)")
    never = [k for k in PATH_KERNELS["limits"] if r["counts"][k] == 0]
    if never:
        failures.append(f"limits: kernels never launched on the path: {never}")
    if not any(v.startswith("rendering_") for v in r["vis"]):
        failures.append("limits: no rendering in vis/")


# ---------------------------------------------------------------------------
# phase 5d: grids beyond 32 levels or 8 channels through the SLAM loop
# ---------------------------------------------------------------------------

def run_wide(dev, flagship_dir: str) -> dict:
    """The wide-grid conf through exp_runner for WIDE_FRAMES frames, with
    its grids' shapes."""
    r = run_counted(dev, write_conf("wide", flagship_dir, WIDE_FRAMES), "exps_wide",
                    WIDE_FRAMES)
    runner = r.pop("runner")
    comb, rend = runner.scene_cfg.combine, runner.scene_cfg.render
    r["grids"] = {name: (spec.num_levels, spec.level_dim, spec.total_entries)
                  for name, spec in (("coarse", comb.coarse.hash_spec()),
                                     ("fine", comb.fine.hash_spec()),
                                     ("color", rend.hash_spec()))}
    del runner
    return r


def report_wide(w: dict, failures) -> None:
    import torch
    log("  grids (levels, channels, rows): "
        + " ".join(f"{k}={v}" for k, v in w["grids"].items()))
    log("  translation error vs GT per frame: "
        + " ".join(f"{i}:{e:.4f}" for i, e in enumerate(w["errs"])))
    log("  " + " ".join(f"{k}={v:.4g}" for k, v in w["stats"].items()))
    log("  launches: " + " ".join(f"{k}={v}" for k, v in w["counts"].items() if v))
    for f, terms in w["map_terms"].items():
        log(f"  loss terms, last iteration of the frame-{f} mapping call: "
            + " ".join(f"{k}={float(v):.5g}" for k, v in terms.items()))
    if not all(e == e and e < 1e3 for e in w["errs"]):
        failures.append("wide: non-finite poses")
    bad = [(f, k) for f, terms in w["map_terms"].items() for k, v in terms.items()
           if not torch.isfinite(v).all()]
    if bad or not w["map_terms"]:
        failures.append(f"wide: non-finite loss terms {bad} (or no mapping call)")
    # every grid wide, so that each K1/K2 launch counted here was at a wide
    # shape
    narrow = [k for k, (L, C, _) in w["grids"].items() if L <= 32 and C <= 8]
    never = [k for k in PATH_KERNELS["wide"] if w["counts"][k] == 0]
    if narrow or never:
        failures.append(f"wide: grids not wide {narrow}, kernels never launched {never}")
    if w["counts"]["sdf_density.grid"] or w["counts"]["sdf_density.rays"]:
        failures.append("wide: the shipped K6 ran a network it was not built for")


# ---------------------------------------------------------------------------
# phase 9: ray-parallel mapping and the scene-parallel sweep
# ---------------------------------------------------------------------------

# the dry runs: NCCL at world size 1 (the production backend's set-up and
# collectives), and two gloo ranks sharing the card held against the
# one-process step, right after phase 3, while the scans are written;
# both at the flagship's full widths (8192 rays at 680 x 1200, its grids),
# parallel.dryrun.ITERS mapping iterations in each mode
NCCL_DRYRUN = ("nccl", 1, [])
GLOO_DRYRUN = ("gloo", 2, ["--backend", "gloo", "--device", "cuda:0", "--check"])
# the sweep: two scenes with the demo networks (the demo scan, and the
# flagship scan at 680 x 1200), both time-sharing the card, SWEEP_FRAMES
# frames each, each equal to its solo run bit for bit
SWEEP_FRAMES = 6


def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def start_dryrun(backend: str, world: int, extra):
    """parallel.dryrun under torchrun in a child process (its output to a
    file, read by finish_dryrun)."""
    path = os.path.join(SMOKE_DIR, f"dryrun_{backend}.json")
    log_f = open(os.path.join(SMOKE_DIR, f"dryrun_{backend}.log"), "w")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(world),
           "--master_addr", "localhost", "--master_port", str(free_port()), "-m",
           "nicer_slam_tpu_torch.parallel.dryrun", "--full", "--out", path] + extra
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT)
    return dict(proc=proc, log_f=log_f, path=path, check="--check" in extra,
                t=time.perf_counter())


def finish_dryrun(run: dict) -> dict:
    rc = run["proc"].wait()
    run["log_f"].close()
    with open(run["log_f"].name) as f:
        text = f.read()
    res = {"rc": rc, "s": time.perf_counter() - run["t"], "check": run["check"],
           "lines": [ln for ln in text.splitlines() if ln.startswith("dryrun")],
           "stderr": text[-3000:]}
    if rc == 0:
        with open(run["path"]) as f:
            res["report"] = json.load(f)
    return res


def sweep_confs(demo_dir: str, flagship_dir: str):
    """(confs, scan ids) of the sweep's two scenes: the demo conf on the
    demo scan, and on the flagship scan at its 680 x 1200 (the preprocess
    run's conf edits)."""
    return ([write_conf("demo", demo_dir, SWEEP_FRAMES, "_sweep"),
             write_conf("preprocess", flagship_dir, SWEEP_FRAMES, "_sweep")],
            [PATHS["demo"]["scan_id"], PATHS["flagship"]["scan_id"]])


def run_sweep(dev, demo_dir: str, flagship_dir: str) -> dict:
    """parallel.sweep on the two scenes (one card, two scenes on it), then
    each scene alone through exp_runner in this process; the launch counts
    are the swept scenes' own (each read in its process), not the solo
    runs'."""
    import numpy as np
    import torch
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.parallel.sweep import sweep
    from nicer_slam_tpu_torch.training import exp_runner

    confs, scans = sweep_confs(demo_dir, flagship_dir)
    for d in ("exps_sweep", "exps_solo"):
        shutil.rmtree(os.path.join(SMOKE_DIR, d), ignore_errors=True)
    t = time.perf_counter()
    results = sweep(confs, root_dir=SMOKE_DIR, exps_folder="exps_sweep", scan_ids=scans,
                    scenes_per_device=2)
    sweep_s = time.perf_counter() - t

    def poses(run_dir):
        path = os.path.join(run_dir, "checkpoints", "PoseParameters", "latest.npz")
        with np.load(path, allow_pickle=True) as z:
            return z["est_poses"]

    solo_s, same = [], []
    for conf, scan, r in zip(confs, scans, results):
        t = time.perf_counter()
        solo = exp_runner.main(["--conf", conf, "--root_dir", SMOKE_DIR, "--exps_folder",
                                "exps_solo", "--scan_id", str(scan), "--device", str(dev)])
        solo_s.append(time.perf_counter() - t)
        same.append(bool(r.get("ok")) and np.array_equal(poses(r["run_dir"]),
                                                         poses(solo.rundir)))
        del solo
        torch.cuda.empty_cache()
    counts = {k: sum(r.get("launches", {}).get(k, 0) for r in results)
              for k in _cuda.launch_counts()}
    return dict(results=results, sweep_s=sweep_s, solo_s=solo_s, same=same, counts=counts)


def report_parallel(dr: dict, sw: dict, failures) -> None:
    for name, res in dr.items():
        log(f"  dryrun {name} ({res['s']:.1f} s to its collection, rc {res['rc']}):")
        for ln in res["lines"]:
            log(f"    {ln}")
        rep = res.get("report")
        if res["rc"] != 0 or rep is None:
            log(res["stderr"])
            failures.append(f"parallel: dryrun {name} failed (rc {res['rc']})")
            continue
        for mode, m in rep["modes"].items():
            log(f"    {mode}: losses {m['losses']} ms/iter {m['ms_per_iter']} sent "
                f"{m['allreduce_bytes']:.0f} B {m['sent_bytes']} (gradient all-reduce alone "
                f"{m['allreduce_ms']:.2f} ms); colour grid {m['color_grid_bytes_per_rank']} B "
                f"per rank (table and Adam moments); peak device memory per rank "
                f"{m.get('max_memory_allocated_per_rank')} B (rank 0 per iteration: at its "
                f"start, peak before and after the Adam step {m.get('memory_per_iter')}); "
                f"bf16 tables {m['bf16_tables']}, "
                f"sharded_tables: {m['sharded_tables']} "
                f"{m.get('collectives_served', '')}")
            if "check" in m and not m["check"]["ok"]:
                failures.append(f"parallel: {name} {mode} differs from the one-process step "
                                f"{m['check']}")
        # the sharded mode shards the flagship's colour grid at two ranks and
        # takes the replicated path at one (sharded_applies), and its
        # backward is the bf16-row kernel's
        sharded = rep["modes"].get("sharded", {})
        want = 1 if rep["world"] > 1 else 0
        if sharded.get("sharded_tables") != want:
            failures.append(f"parallel: {name} sharded_tables {sharded.get('sharded_tables')}, "
                            f"expected {want}")
        bwd = rep.get("launches", {}).get("hash_encode_bf16.bwd", 0)
        if (bwd > 0) != bool(want):
            failures.append(f"parallel: {name} launched hash_encode_bf16.bwd {bwd} times")
        if res["check"] and "reference" not in rep:
            failures.append(f"parallel: {name} ran no one-process check")
    log(f"  sweep: 2 scenes on one card in {sw['sweep_s']:.1f} s (solo runs "
        f"{' '.join(f'{s:.1f}' for s in sw['solo_s'])} s)")
    for r, same in zip(sw["results"], sw["same"]):
        log(f"    ok={r.get('ok')} device={r.get('device')} wall {r.get('wall_s', 0):.1f} s "
            f"-> {r.get('run_dir')}; poses equal to the solo run bit for bit: {same}")
        if not r.get("ok"):
            log(r.get("error", ""))
    if not all(sw["same"]):
        failures.append("parallel: a swept scene's poses differ from its solo run")


# ---------------------------------------------------------------------------
# phase 10: the long-run evaluation, GUARDED's settings
# ---------------------------------------------------------------------------

# tools/r5f_queue.sh's guarded command (the JAX package's
# LONG_SEQ_GUARDED_r05.json) through frame LONG_FRAMES (frames 0 to 50,
# so that the interim at frame 50 runs); the mesh battery at 128³ on
# 50,000 points and 2 extrapolated views
LONG_FRAMES = 50
LONG_ARGS = ["--frames", str(LONG_FRAMES + 1), "--rad_per_frame", "0.003", "--iters", "60",
             "--track_iters", "100", "--rays", "4096", "--track_rays", "1024", "--lr", "0.002",
             "--track_lr", "0.005", "--track_lr_step", "12", "--track_lr_gamma", "0.5",
             "--motion_prior_spring", "0.1", "--ba_trust_radius", "0.01", "--ba_trust_rot",
             "1.0", "--cam_freespace_w", "10.0", "--cam_freespace_margin", "0.05", "--ba",
             "--mef", "5", "--color_topk", "16", "--checkpoint_freq", "50",
             "--interim_every", "50", "--mesh_res", "128", "--rec_points", "50000",
             "--n_eval_views", "2"]
# frame 50 of the JAX record (LONG_SEQ_GUARDED_r05.json) and the bound
# tests/test_torch_eval_e2e.py holds the port to: max(1.5 x JAX, JAX + 0.01)
JAX_ATE_AT_50 = 0.004063656575156802


def start_long_run():
    root = os.path.join(SMOKE_DIR, "long_seq")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    log_f = open(os.path.join(SMOKE_DIR, "long_seq.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nicer_slam_tpu_torch.evaluation.long_seq_eval", *LONG_ARGS,
         "--root", root], cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT)
    return proc, log_f, time.perf_counter()


def finish_long_run(run) -> dict:
    proc, log_f, t0 = run
    rc = proc.wait()
    log_f.close()
    out = {"rc": rc, "s": time.perf_counter() - t0}
    path = os.path.join(SMOKE_DIR, "long_seq", "long_seq_eval.json")
    if os.path.exists(path):
        with open(path) as f:
            out["res"] = json.load(f)
    return out


def report_long_run(lr: dict, failures) -> None:
    import math
    res = lr.get("res", {})
    log(f"  rc {lr['rc']}, {lr['s']:.1f} s to its collection; s/frame "
        f"{res.get('s_per_frame', float('nan')):.3f}; phases "
        + " ".join(f"{k}={v:.1f}" for k, v in res.get("phase_s", {}).items()))
    last = res.get("interim", [{}])[-1] if res.get("interim") else {}
    ate = last.get("ate_rmse", float("nan"))
    bound = max(1.5 * JAX_ATE_AT_50, JAX_ATE_AT_50 + 0.01)
    log(f"  frame {last.get('frame')}: ATE RMSE {ate:.6f} (JAX record {JAX_ATE_AT_50:.6f}, "
        f"bound {bound:.6f}: {'within' if ate <= bound else 'outside'}), rot drift "
        f"{last.get('rot_drift_deg', float('nan')):.2f} deg, sdf negative share "
        f"{last.get('sdf_negfrac')}, frame-0 PSNR {last.get('psnr_frame0')}")
    for k in ("eval_cam", "eval_rec", "eval_rendering_interpolate",
              "eval_rendering_extrapolate"):
        log(f"  {k}: {json.dumps(res.get(k))}")
    rec = res.get("eval_rec", {})
    if lr["rc"] != 0 or not math.isfinite(ate) or last.get("frame") != LONG_FRAMES:
        with open(os.path.join(SMOKE_DIR, "long_seq.log")) as f:
            log(f.read()[-3000:])
        failures.append(f"long run: rc {lr['rc']}, ATE at frame {last.get('frame')} {ate}")
    if "error" in rec or not 0.0 < last.get("sdf_negfrac", 0.0) < 1.0:
        failures.append(f"long run: the mesh has no surface ({rec}, sdf negative share "
                        f"{last.get('sdf_negfrac')})")


# ---------------------------------------------------------------------------
# phase 8: preprocessing on the card
# ---------------------------------------------------------------------------

class StageTimer:
    """Wall seconds of every call of ``module.name`` while active (the card
    synchronised after each), summed under ``key``."""

    def __init__(self, times: dict, key: str, module, name: str):
        self.times, self.key, self.module, self.name = times, key, module, name

    def __enter__(self):
        import torch
        fn = self.orig = getattr(self.module, self.name)

        def timed(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.times[self.key] = self.times.get(self.key, 0.0) + time.perf_counter() - t
            return out

        setattr(self.module, self.name, timed)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _read_lzma(path):
    import lzma
    import numpy as np
    with lzma.open(path) as f:
        return np.load(f)


def _finite(failures, what, *arrays):
    import numpy as np
    if not all(np.isfinite(a).all() for a in arrays):
        failures.append(f"preprocess: non-finite {what}")


def check_converted(scan: str, poses_world, failures) -> None:
    """The converter's on-disk contract (tests/test_preprocess_e2e.py:87-140):
    cameras, images, lzma cues, the 0 <-> 10 flow pair, the normalised mesh."""
    import numpy as np
    H, W = PATHS["preprocess"]["H"], PATHS["preprocess"]["W"]
    cams = np.load(os.path.join(scan, "cameras.npz"))
    K4 = np.eye(4)
    K4[0, 0], K4[1, 1], K4[0, 2], K4[1, 2] = REPLICA_K
    want = (K4 @ np.linalg.inv(poses_world[3])).astype(np.float32)
    sm = cams["scale_mat_0"]
    problems = []
    if sorted(cams.files) != sorted([f"world_mat_{i}" for i in range(CAPTURE_FRAMES)]
                                    + [f"scale_mat_{i}" for i in range(CAPTURE_FRAMES)]):
        problems.append("cameras.npz keys")
    if not np.allclose(cams["world_mat_3"], want, rtol=1e-5):
        problems.append("world_mat_3")
    if not (sm[0, 0] == sm[1, 1] == sm[2, 2] and sm[0, 0] > 1.0):
        problems.append("scale_mat")
    for i in range(CAPTURE_FRAMES):
        for name in ("rgb.png", "gt_depth.png"):
            if not os.path.exists(os.path.join(scan, f"{i:06d}_{name}")):
                problems.append(f"{i:06d}_{name}")
        dp = os.path.join(scan, f"{i:06d}_depth.npy")
        with open(dp, "rb") as f:
            if f.read(6) != b"\xfd7zXZ\x00":
                problems.append(f"{dp} is not lzma")
        d, n = _read_lzma(dp), _read_lzma(os.path.join(scan, f"{i:06d}_normal.npy"))
        if d.shape != (H, W) or n.shape != (3, H, W):
            problems.append(f"cue shapes {d.shape} {n.shape}")
        _finite(failures, f"cues of frame {i}", d, n)
    for name in ("0000_0010_flow.npy", "0000_0010_occ.png", "0010_0000_flow.npy"):
        if not os.path.exists(os.path.join(scan + "_pair", name)):
            problems.append(name)
    if not os.path.exists(os.path.join(os.path.dirname(scan), f"{CAPTURE_SCENE}_mesh_01.ply")):
        problems.append("normalised mesh")
    if problems:
        failures.append(f"preprocess: the converted scan breaks its contract: {problems}")


def flow_epe(rgb_dir: str, geo_dir: str, pairs) -> dict:
    """Per pair: the classical flow, and its mean end-point error against the
    geometric flow over the pixels both call usable and over those the
    geometric one calls usable, with the shares of such pixels."""
    import cv2
    import numpy as np
    out = {}
    for i, j in pairs:
        stem = f"{i:04d}_{j:04d}"
        fc, fg = (_read_lzma(os.path.join(d, f"{stem}_flow.npy")) for d in (rgb_dir, geo_dir))
        geo = cv2.imread(os.path.join(geo_dir, f"{stem}_occ.png"))[..., 0] == 0
        both = geo & (cv2.imread(os.path.join(rgb_dir, f"{stem}_occ.png"))[..., 0] == 0)
        epe = np.linalg.norm(fc - fg, axis=-1)
        out[stem] = dict(flow=fc, **{
            f"epe_{name}": float(epe[m].mean()) if m.any() else float("nan")
            for name, m in (("both", both), ("geo", geo))},
            share_both=float(both.mean()), share_geo=float(geo.mean()))
    return out


def network_ms(dev, mono, depth_ckpt: str, flow_ckpt: str, img, img1) -> dict:
    """CUDA-event times of each network's forward alone (no resize, no
    copy), mean of 5 after 1: the mono prior at 680 x 1200 (padded to 680 x
    1200, a multiple of 4), DPT at 384² and GMFlow at 704 x 1216. These are
    library calls (cuDNN/cuBLAS convolutions, products, softmaxes)."""
    import numpy as np
    import torch
    from nicer_slam_tpu_torch.models import dpt, gmflow

    def dev_img(a, pad_to=1):
        H, W = a.shape[:2]
        a = np.pad(a, ((0, -H % pad_to), (0, -W % pad_to), (0, 0)))
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)[None]

    out = {}
    with torch.no_grad():
        x = dev_img(img, 4)
        out["mono_prior"] = cuda_time(lambda: mono.model(x), iters=5, warmup=1)
        net = dpt.DPTInference(depth_ckpt, "depth", dev).model
        x = torch.rand(1, 384, 384, 3, device=dev)
        out["dpt"] = cuda_time(lambda: net(x), iters=5, warmup=1)
        del net
        net = gmflow.GMFlowInference(flow_ckpt, dev).model
        a, b = dev_img(img, 32), dev_img(img1, 32)
        out["gmflow"] = cuda_time(lambda: net(a, b), iters=5, warmup=1)
    return out


def run_preprocess(dev, capture: str) -> dict:
    """Phase 8: the raw capture through the port's preprocessing entry points
    on the card, then the demo networks on the converted scan."""
    import numpy as np
    import torch
    from nicer_slam_tpu_torch.evaluation.eval_rec import calc_3d_metric
    from nicer_slam_tpu_torch.models import dpt, gmflow, layers
    from nicer_slam_tpu_torch.models.mono_prior import MonoPriorInference
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.ops import tsdf as tsdf_ops
    from nicer_slam_tpu_torch.preprocess import extract_flows as ef
    from nicer_slam_tpu_torch.preprocess import extract_monocular_cues as emc
    from nicer_slam_tpu_torch.preprocess import replica_2_volsdf, tsdf_fusion
    from nicer_slam_tpu_torch.preprocess.common import read_rgb

    work = os.path.join(SMOKE_DIR, "preprocess")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "Replica")
    scan = os.path.join(root, "scan1")
    failures, times = [], {}
    poses = np.loadtxt(os.path.join(capture, "traj.txt")).reshape(-1, 4, 4)
    pairs = ef._pairs(list(range(0, CAPTURE_FRAMES, 10)))
    _cuda.reset_launch_counts()

    # convert: images and cameras, cues from mono_prior.npz, geometric flows
    t = time.perf_counter()
    with StageTimer(times, "cues", emc, "extract_cues"), \
            StageTimer(times, "geometric", ef, "extract_flows"):
        replica_2_volsdf.convert_scene(capture, scan, scan_id=1, with_cues=True,
                                       with_flow=True, intrinsics=REPLICA_K, device=str(dev))
    times["convert"] = time.perf_counter() - t
    check_converted(scan, poses, failures)
    img0, img10 = read_rgb(os.path.join(scan, "000000_rgb.png")), \
        read_rgb(os.path.join(scan, "000010_rgb.png"))
    mono = MonoPriorInference(emc._default_mono_prior_path(), dev)
    d_card, n_card = mono(img0)
    t = time.perf_counter()
    d_cpu, n_cpu = MonoPriorInference(emc._default_mono_prior_path(), "cpu")(img0)
    times["mono_prior_cpu"] = time.perf_counter() - t
    mono_err = max(float(np.abs(d_card - d_cpu).max()), float(np.abs(n_card - n_cpu).max()))
    if not mono_err <= MONO_PRIOR_ATOL:
        failures.append(f"preprocess: the mono prior on the card differs from the CPU by "
                        f"{mono_err:.3e} > {MONO_PRIOR_ATOL:g}")

    # RGB-only flows over the same keyframe pairs: classical, on the card
    rgb_pairs = os.path.join(work, "pairs_rgb_only")
    with StageTimer(times, "classical_compute", ef, "classical_flow"):
        t = time.perf_counter()
        ef.extract_flows(scan, rgb_pairs, rgb_only=True, device=str(dev))
        times["classical"] = time.perf_counter() - t
    epe = flow_epe(rgb_pairs, scan + "_pair", pairs)
    _finite(failures, "classical flows", *(e["flow"] for e in epe.values()))
    h, w = CLASSICAL_CROP
    cl_card = ef.classical_flow(img0[:h, :w], img10[:h, :w], device=str(dev))
    cl_cpu = ef.classical_flow(img0[:h, :w], img10[:h, :w], device="cpu")
    classical_err = float(np.abs(cl_card - cl_cpu).max())
    if not classical_err <= CLASSICAL_ATOL:
        failures.append(f"preprocess: the classical flow on the card differs from the CPU "
                        f"by {classical_err:.3e} px > {CLASSICAL_ATOL:g}")

    # GMFlow and DPT from seeded weights, through the --ckpt / --depth_ckpt
    # paths of the extraction CLIs, on one keyframe pair and one frame
    one = os.path.join(work, "one_pair")
    os.makedirs(one)
    for k, src in enumerate((0, 10)):
        shutil.copyfile(os.path.join(scan, f"{src:06d}_rgb.png"),
                        os.path.join(one, f"{k:06d}_rgb.png"))
    ckpts = {"flow": os.path.join(work, "gmflow_seeded.npz"),
             "depth": os.path.join(work, "dpt_depth_seeded.npz"),
             "normal": os.path.join(work, "dpt_normal_seeded.npz")}
    np.savez(ckpts["flow"], **layers.to_flat(layers.init_seeded(gmflow.GMFlow(), 1)))
    for task, oc in (("depth", 1), ("normal", 3)):
        np.savez(ckpts[task], **layers.to_flat(layers.init_seeded(dpt.DPT(oc), 1 + oc)))
    with StageTimer(times, "gmflow_compute", gmflow.GMFlowInference, "__call__"):
        t = time.perf_counter()
        ef.main(["--inference_dir", one, "--output_path", os.path.join(work, "pairs_gmflow"),
                 "--ckpt", ckpts["flow"], "--keyframe_every", "1", "--device", str(dev)])
        times["gmflow"] = time.perf_counter() - t
    gm = _read_lzma(os.path.join(work, "pairs_gmflow", "0000_0001_flow.npy"))
    _finite(failures, "GMFlow flow", gm)
    only = os.path.join(work, "one_frame")
    os.makedirs(only)
    shutil.copyfile(os.path.join(scan, "000000_rgb.png"), os.path.join(only, "000000_rgb.png"))
    with StageTimer(times, "dpt_compute", dpt.DPTInference, "__call__"):
        t = time.perf_counter()
        emc.main(["--img_path", only, "--output_path", os.path.join(work, "cues_dpt"),
                  "--depth_ckpt", ckpts["depth"], "--normal_ckpt", ckpts["normal"],
                  "--device", str(dev)])
        times["dpt"] = time.perf_counter() - t
    dd = _read_lzma(os.path.join(work, "cues_dpt", "000000_depth.npy"))
    dn = _read_lzma(os.path.join(work, "cues_dpt", "000000_normal.npy"))
    _finite(failures, "DPT cues", dd, dn)
    if gm.shape != img0.shape[:2] + (2,) or dd.shape != img0.shape[:2] \
            or dn.shape != (3,) + img0.shape[:2]:
        failures.append(f"preprocess: GMFlow / DPT shapes {gm.shape} {dd.shape} {dn.shape}")

    # TSDF fusion of the 21 GT depths at 256³ through K9, against the
    # analytic scene mesh (world units, no ICP)
    ply = os.path.join(work, "tsdf_mesh.ply")
    with StageTimer(times, "tsdf_integrate", tsdf_ops, "integrate"):
        t = time.perf_counter()
        tsdf_fusion.main(["--scan_dir", scan, "--out", ply, "--res", str(TSDF_RES),
                          "--depth_scale", "6553.5", "--every", "1", "--device", str(dev)])
        times["tsdf"] = time.perf_counter() - t
    t = time.perf_counter()
    rec = calc_3d_metric(ply, os.path.join(os.path.dirname(capture), f"{CAPTURE_SCENE}_mesh.ply"),
                         n_points=TSDF_EVAL_POINTS, do_icp=False)
    times["calc_3d_metric"] = time.perf_counter() - t
    _finite(failures, "TSDF mesh metrics", np.array(list(rec.values())))
    counts = _cuda.launch_counts()
    net_ms = network_ms(dev, mono, ckpts["depth"], ckpts["flow"], img0, img10)
    if counts["tsdf.integrate"] != CAPTURE_FRAMES:
        failures.append(f"preprocess: K9 launched {counts['tsdf.integrate']} times for "
                        f"{CAPTURE_FRAMES} frames")
    torch.cuda.empty_cache()

    # SLAM on the converted scan: the frame-10 mapping call reads the
    # converter's 0 <-> 10 flow pair and the card-made cues
    slam = run_slam(dev, "preprocess", root)
    slam["counts"] = {k: v + slam["counts"][k] for k, v in counts.items()}
    return dict(slam=slam, failures=failures, times=times, epe=epe, rec=rec,
                mono_err=mono_err, classical_err=classical_err,
                classical_equal=bool(np.array_equal(cl_card, cl_cpu)), n_pairs=len(pairs),
                net_ms=net_ms)


def report_preprocess(pre: dict, failures) -> None:
    t = pre["times"]
    n = pre["n_pairs"]
    log(f"  convert {t['convert']:.2f} s ({CAPTURE_FRAMES} frames: cues {t['cues']:.2f} s = "
        f"{t['cues'] / CAPTURE_FRAMES:.3f} s/frame, geometric flows {t['geometric']:.2f} s = "
        f"{t['geometric'] / n:.3f} s/pair over {n} pairs, with the lzma writes)")
    log(f"  mono prior card vs CPU on frame 0: {pre['mono_err']:.3e} (tolerance "
        f"{MONO_PRIOR_ATOL:g}; the CPU forward {t['mono_prior_cpu']:.2f} s)")
    log("  network forwards alone (library calls, CUDA events): "
        + " ".join(f"{k} {v:.3f} ms" for k, v in pre["net_ms"].items()))
    log(f"  classical flows {t['classical']:.2f} s = {t['classical'] / n:.3f} s/pair "
        f"(classical_flow alone {t['classical_compute'] / n:.3f} s/pair, float64 on the card)")
    log(f"  classical flow card vs CPU at {CLASSICAL_CROP[0]}x{CLASSICAL_CROP[1]} (frames 0, "
        f"10): {pre['classical_err']:.3e} px, bit for bit {pre['classical_equal']} "
        f"(tolerance {CLASSICAL_ATOL:g})")
    for stem, e in pre["epe"].items():
        log(f"    {stem}: end-point error vs geometric {e['epe_both']:.4f} px over the "
            f"{e['share_both']:.2%} of pixels usable in both, {e['epe_geo']:.4f} px over "
            f"the {e['share_geo']:.2%} the geometric flow calls usable")
    log(f"  GMFlow (seeded, 704x1216 padded) {t['gmflow']:.2f} s for 1 pair both ways "
        f"(network {t['gmflow_compute'] / 2:.3f} s/direction)")
    log(f"  DPT (seeded, 384²) depth + normal {t['dpt']:.2f} s for 1 frame (networks "
        f"{t['dpt_compute'] / 2:.3f} s/head, with the resizes)")
    log(f"  TSDF {TSDF_RES}³ over {CAPTURE_FRAMES} frames {t['tsdf']:.2f} s (integrate "
        f"{t['tsdf_integrate'] / CAPTURE_FRAMES * 1e3:.3f} ms/frame with the host copy); "
        f"mesh vs the analytic scene ({TSDF_EVAL_POINTS} points, {t['calc_3d_metric']:.2f} s): "
        + " ".join(f"{k}={v:.5g}" for k, v in pre["rec"].items()))
    failures.extend(pre["failures"])
    report("preprocess", pre["slam"], failures)


# ---------------------------------------------------------------------------
# phases 8 and 9's sweep in a child process beside phases 5b to 7: both need
# only the scans, and no other phase reads what they write
# ---------------------------------------------------------------------------

LANE_B_OUT = os.path.join(SMOKE_DIR, "lane_b.pkl")


def _host(obj):
    """obj with every tensor moved to the host (for the pickle)."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def lane_b(capture: str, demo_dir: str, flagship_dir: str) -> None:
    """Phase 8, then phase 9's sweep, on the card; their results pickled to
    LANE_B_OUT (the SLAM run's runner kept as its plots directory)."""
    import pickle
    import types
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    pre = run_preprocess(dev, capture)
    pre["phase_s"] = time.perf_counter() - t
    pre["slam"]["runner"] = types.SimpleNamespace(plots_dir=pre["slam"]["runner"].plots_dir)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    sw = run_sweep(dev, demo_dir, flagship_dir)
    sw["phase_s"] = time.perf_counter() - t
    with open(LANE_B_OUT + ".tmp", "wb") as f:
        pickle.dump(_host({"pre": pre, "sw": sw}), f)
    os.replace(LANE_B_OUT + ".tmp", LANE_B_OUT)


def start_lane_b(capture: str, demo_dir: str, flagship_dir: str):
    if os.path.exists(LANE_B_OUT):
        os.remove(LANE_B_OUT)
    log_f = open(os.path.join(SMOKE_DIR, "lane_b.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.lane_b({capture!r}, "
         f"{demo_dir!r}, {flagship_dir!r})"], cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT)
    return proc, log_f


def finish_lane_b(lane) -> dict:
    import pickle
    proc, log_f = lane
    rc = proc.wait()
    log_f.close()
    if rc != 0 or not os.path.exists(LANE_B_OUT):
        with open(log_f.name) as f:
            log(f.read()[-6000:])
        raise RuntimeError(f"phases 8 and 9's sweep failed in their process (rc {rc})")
    with open(LANE_B_OUT, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# phase 6: the evaluation battery on the flagship run
# ---------------------------------------------------------------------------

def run_eval(dev, flagship: dict, data_dir: str) -> dict:
    """The port's eval_checkpoint CLI on the flagship run's directory, on
    the card, with the launch counters reset just before and read just
    after; then, outside the counted phase, the pose= render check and
    LPIPS on the card against the CPU at view 2."""
    import torch
    from nicer_slam_tpu_torch.evaluation import eval_checkpoint
    from nicer_slam_tpu_torch.models.lpips import LPIPSMetric
    from nicer_slam_tpu_torch.ops import _cuda

    runner = flagship["runner"]
    argv = ["--rundir", runner.rundir, "--mesh_res", str(MESH_RESOLUTION),
            "--synthetic_gt_mesh", "--eval_data_dir", data_dir + "_eval",
            "--n_eval_views", str(PATHS["flagship"]["eval_views"]), "--device", str(dev)]
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t = time.perf_counter()
    res = eval_checkpoint.main(argv)
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t
    counts = _cuda.launch_counts()

    # the pose= path: view 2 at its estimated pose, against the default
    renders, render_s = [], []
    for kw in ({}, {"pose": runner.est_pose_all[2]}):
        t = time.perf_counter()
        renders.append(runner.render_full_image(2, **kw))
        render_s.append(time.perf_counter() - t)
    same_pose = all(same_bits(renders[0][k], renders[1][k]) for k in renders[0])
    gt_rgb = runner.dataset.frame(2)["rgb"].reshape(runner.H, runner.W, 3)
    lp = {where: LPIPSMetric(os.path.join(ROOT, "lpips_alex.npz"), device=d)
          for where, d in (("card", dev), ("cpu", "cpu"))}
    lp_vals = {where: m(renders[0]["rgb"], gt_rgb) for where, m in lp.items()}
    return dict(res=res, counts=counts, phase_s=phase_s, render_s=render_s,
                same_pose=same_pose, lpips=lp_vals,
                lpips_metric=lp["cpu"].metric_name)


def report_eval(e: dict, failures) -> None:
    """Print the battery's quality numbers and times; append what failed."""
    import numpy as np
    from nicer_slam_tpu_torch.evaluation.eval_checkpoint import failed_sections

    res, counts = e["res"], e["counts"]
    cam = res.get("eval_cam", {})
    rec = res.get("eval_rec", {})
    it = res.get("eval_rendering_interpolate", {})
    ex = res.get("eval_rendering_extrapolate", {})
    rows = res["depth_bias"] if isinstance(res.get("depth_bias"), list) else []
    g = lambda d, k: d.get(k, float("nan"))
    log(f"  eval_cam: ATE RMSE {g(cam, 'ate_rmse'):.6g}, rotation drift "
        f"{g(cam, 'rot_drift_deg'):.6g} deg (max {g(cam, 'rot_drift_max_deg'):.6g}), "
        f"sim3 rot error {g(cam, 'rot_error_deg'):.6g} deg, {g(cam, 'n_frames'):g} frames")
    log(f"  eval_rec (mesh {MESH_RESOLUTION}^3 vs the analytic scene mesh): accuracy "
        f"{g(rec, 'accuracy'):.6g}, completion {g(rec, 'completion'):.6g}, completion ratio "
        f"{g(rec, 'completion_ratio_5cm'):.6g}, normal consistency "
        f"{g(rec, 'normal_consistency'):.6g}, F-score@0.01/0.015/0.02 "
        f"{g(rec, 'fscore@0.01'):.6g}/{g(rec, 'fscore@0.015'):.6g}/{g(rec, 'fscore@0.02'):.6g}")
    for row in rows:
        log(f"  depth bias frame {row['frame']}: median ratio {row['depth_ratio_median']:.6g}, "
            f"MAE {row['depth_mae']:.6g}")
    for name, d in (("interpolate", it), ("extrapolate", ex)):
        log(f"  {name} ({g(d, 'n_views'):g} views): PSNR {g(d, 'psnr'):.6g}, SSIM "
            f"{g(d, 'ssim'):.6g}, {e['lpips_metric']} {g(d, 'lpips'):.6g}")
    log(f"  eval phase {e['phase_s']:.2f} s (wall {res.get('wall_s')} s inside the battery); "
        f"s per eval render (view 2, twice) " + " ".join(f"{s:.3f}" for s in e["render_s"]))
    log("  launches: " + " ".join(f"{k}={v}" for k, v in counts.items()))
    lp = e["lpips"]
    d_lp = abs(lp["card"] - lp["cpu"])
    log(f"  {e['lpips_metric']} at view 2: {lp} (|card - cpu| {d_lp:.3e}, tolerance "
        f"{LPIPS_ATOL:g}); pose= render equal bit for bit: {e['same_pose']}")
    bad = failed_sections(res)
    need = ("eval_cam", "eval_rec", "depth_bias", "eval_rendering_interpolate",
            "eval_rendering_extrapolate")
    missing = [k for k in need if k not in res]
    if bad or missing:
        failures.append(f"eval: sections with an error {bad}, missing {missing}: "
                        + json.dumps({k: res.get(k) for k in bad + ["eval_rendering_error"]
                                      if k in res}))
    values = [v for k in need if isinstance(res.get(k), dict) for v in res[k].values()]
    values += [v for row in rows for v in row.values()]
    if not values or not np.isfinite(values).all():
        failures.append("eval: non-finite values in the battery's results")
    if ex.get("n_views") != PATHS["flagship"]["eval_views"]:
        failures.append(f"eval: {ex.get('n_views')} extrapolated views")
    never = [k for k in EVAL_KERNELS if counts.get(k, 0) == 0]
    if never or counts.get("hash_encode_bf16", 0):
        failures.append(f"eval: kernels never launched {never}, or K3 launched "
                        f"({counts.get('hash_encode_bf16', 0)})")
    if not e["same_pose"]:
        failures.append("eval: render_full_image(2, pose=its estimate) differs from "
                        "render_full_image(2)")
    if not d_lp <= LPIPS_ATOL:
        failures.append(f"eval: LPIPS on the card {lp} differs from the CPU by {d_lp:.3e}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    from nicer_slam_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log_phase(f"[1/11] card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    procs = start_scenes()
    long_run = lane = None
    try:
        t = time.perf_counter()
        path = _cuda.build()
        _cuda.library()
        log_phase(f"[2/11] build: {os.path.relpath(path, ROOT)} in "
                  f"{time.perf_counter() - t:.1f} s")

        log_phase(f"[3/11] kernels vs plain versions (tolerance: values {VAL_RTOL:g}·max|ref| "
            f"per output, atomic gradients rel L2 {GRAD_REL_L2:g}, sampler {Z_ATOL:g} "
            f"on every ray, the voxel counter bit for bit); each kernel's launch "
            f"alone, mean of 10 after 2; the plain versions of K1/K2 once; bounds at "
            f"{HBM_BYTES_PER_S / 1e12:g} TB/s and {FP32_OPS_PER_S / 1e12:g} "
            f"TFLOP/s float32; card {card}")
        chk = Checks()
        check_hash_kernels(dev, chk)
        check_hash_channels(dev, chk)
        check_hash_wide(dev, chk)
        for (R, S), tag in zip(COMPOSITE_SHAPES, COMPOSITE_TAGS):
            check_demo_kernels(dev, chk, R, S, tag)
        check_hash_tracking(dev, chk)
        check_hash_fixed_state(dev, chk)
        check_voxel_kernels(dev, chk)
        check_topk_kernels(dev, chk)
        check_bf16_kernels(dev, chk)
        check_hash_bf16_bwd(dev, chk)
        check_sampler_kernels(dev, chk)
        check_behind_cube(dev, chk)
        check_sdf_density(dev, chk)
        check_sdf_general(dev, chk)
        check_tsdf_kernel(dev, chk)
        torch.cuda.empty_cache()
        log("  past the old limits (the JAX package has none):")
        check_limits(dev, chk)
        torch.cuda.empty_cache()

        # phase 9's dry runs need no scan: they run while the scans are
        # written
        log_phase(f"[9/11] parallel (first part, while the scans are written): parallel.dryrun "
            f"at the flagship's widths, two mapping iterations per mode, under NCCL at "
            f"world size 1 and as two gloo ranks sharing the card (held against the "
            f"one-process step)")
        dryruns = {name: finish_dryrun(start_dryrun(*run))
                   for name, run in (("ncclx1", NCCL_DRYRUN), ("gloox2", GLOO_DRYRUN))}

        runs = {}
        for step, kind in ((4, "demo"), (5, "flagship")):
            t = time.perf_counter()
            data_dir = wait_scene(procs, kind)
            p = PATHS[kind]
            log_phase(f"[{step}/11] SLAM main path: {kind} configuration, {N_FRAMES} frames, "
                f"{p['H']}x{p['W']}, global_window_start {GLOBAL_WINDOW_START} "
                f"(waited {time.perf_counter() - t:.1f} s for the scan)")
            runs[kind] = run_slam(dev, kind, data_dir)
            torch.cuda.empty_cache()
        log_phase(f"[10/11] long run (in the background, beside phases 5b to 9): "
            f"evaluation.long_seq_eval with GUARDED's settings through frame {LONG_FRAMES} "
            f"at 120x160")
        long_run = start_long_run()
        t = time.perf_counter()
        capture = wait_scene(procs, "capture")
        log_phase(f"[8/11] preprocess, then [9/11] parallel.sweep, in a child process beside "
            f"phases 5b to 7 (waited {time.perf_counter() - t:.1f} s for the capture): a raw "
            f"Replica-layout capture ({CAPTURE_FRAMES} frames, "
            f"{PATHS['preprocess']['H']}x{PATHS['preprocess']['W']}) through the port's "
            f"converter, cue and flow extraction and TSDF fusion on the card, the demo "
            f"networks on the converted scan; then the demo networks on two scans "
            f"({SWEEP_FRAMES} frames each, both on the card at once), each held against its "
            f"solo run")
        lane = start_lane_b(capture, wait_scene(procs, "demo"), wait_scene(procs, "flagship"))
        t = time.perf_counter()
        log_phase(f"[5b/11] options: the flagship configuration with the exact prepass, warp "
            f"patches [1 5] under SSIM and exposure, {OPTIONS_FRAMES} frames; then the demo "
            f"networks in nerf mode with per-image codes, {NERF_FRAMES} frames")
        options = run_options(dev, wait_scene(procs, "flagship"), wait_scene(procs, "demo"))
        options["phase_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        log_phase(f"[5c/11] networks: TINY_CONF's SDF networks ({TINY_FRAMES} frames, "
            f"{TINY_H}x{TINY_W}, the exact prepass; then {TINY_CACHED_FRAMES} with the "
            f"density cache) and the flagship with concat_coarse_feature ({CONCAT_FRAMES} "
            f"frames, the exact prepass); Adam in the optax layout; pretrain "
            f"({PRETRAIN_STEPS} steps) and train_mono_prior ({MONO_STEPS})")
        networks = run_networks(dev, wait_scene(procs, "flagship"))
        networks["phase_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        log_phase(f"[5d/11] wide grids: the flagship configuration with a 16-level x 16-channel "
            f"coarse grid, a 40-level fine grid and a 40-level colour grid, {WIDE_FRAMES} "
            f"frames")
        wide = run_wide(dev, wait_scene(procs, "flagship"))
        wide["phase_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        log_phase(f"[5e/11] limits: the demo configuration at its full width "
            f"({PATHS['limits']['H']}x{PATHS['limits']['W']}) with N_samples_eval 1280, "
            f"N_samples 128, N_samples_extra 64 (past the kernels' old limits), "
            f"{LIMITS_FRAMES} frames")
        limits = run_limits(dev, wait_scene(procs, "demo"))
        limits["phase_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        log_phase("[6/11] eval: the checkpoint battery on the flagship run (eval_cam, mesh "
            f"{MESH_RESOLUTION}^3 vs the analytic scene, depth bias, interpolate view 2, "
            f"{PATHS['flagship']['eval_views']} extrapolated views)")
        ev = run_eval(dev, runs["flagship"], wait_scene(procs, "flagship"))
        torch.cuda.empty_cache()
        log_phase(f"[7/11] repeat: the demo configuration twice in this process, "
            f"{REPEAT_FRAMES} frames each (mapping at frames 0 and 5), same seed and scan")
        repeat_failures = []
        check_repeat(dev, wait_scene(procs, "demo"), repeat_failures)
        torch.cuda.empty_cache()
        lane_b = finish_lane_b(lane)
        lane = None
        pre, sw = lane_b["pre"], lane_b["sw"]
        lr = finish_long_run(long_run)
        long_run = None
    finally:
        bg = (list(procs.values()) + ([long_run[0]] if long_run else [])
              + ([lane[0]] if lane else []))
        for proc in bg:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    log_phase("[11/11] report (card: " + card + ")")
    failures = list(chk.failures) + repeat_failures
    for kind, r in runs.items():
        log(f" {kind}:")
        report(kind, r, failures)
    log(f" options (phase {options['phase_s']:.1f} s; {CONTENDED['5b-7']}):")
    report_options(options, failures)
    log(f" networks (phase {networks['phase_s']:.1f} s; {CONTENDED['5b-7']}):")
    report_networks(networks, failures)
    log(f" eval (the flagship run; {CONTENDED['5b-7']}):")
    report_eval(ev, failures)
    log(f" preprocess (phase {pre['phase_s']:.1f} s; {CONTENDED['8-9']}):")
    report_preprocess(pre, failures)
    log(f" wide grids (phase {wide['phase_s']:.1f} s; {CONTENDED['5b-7']}):")
    report_wide(wide, failures)
    log(f" limits (phase {limits['phase_s']:.1f} s; {CONTENDED['5b-7']}):")
    report_limits(limits, failures)
    log(f" parallel (sweep phase {sw['phase_s']:.1f} s; {CONTENDED['8-9']}; the dry runs "
        f"{CONTENDED['dryrun']}):")
    report_parallel(dryruns, sw, failures)
    log(f" long run ({CONTENDED['10']}):")
    report_long_run(lr, failures)

    kernels = []
    for name, r in chk.results.items():
        base = name.split("[")[0]
        by_path = {kind: r_["counts"][base] for kind, r_ in runs.items()}
        by_path["options"] = options["counts"][base]
        by_path["networks"] = networks["counts"][base]
        by_path["eval"] = ev["counts"][base]
        by_path["preprocess"] = pre["slam"]["counts"][base]
        by_path["wide"] = wide["counts"][base]
        by_path["limits"] = limits["counts"][base]
        by_path["parallel"] = (sw["counts"][base] + sum(
            d.get("report", {}).get("launches", {}).get(base, 0) for d in dryruns.values()))
        by_path["long_run"] = lr.get("res", {}).get("launches", {}).get(base, 0)
        kernels.append(dict(r, launches=sum(by_path.values()), launches_by_path=by_path))
    log(json.dumps({"kernels": kernels}))
    log(card)
    if failures:
        print(f"chip_smoke FAILED: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
