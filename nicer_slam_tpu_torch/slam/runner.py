"""SLAMRunner: the experiment shell around track/map (counterpart of
nicer_slam_tpu/slam/runner.py).

Experiment-dir layout exps/<expname>_<scan>/<timestamp>/{vis/,
checkpoints/{Model,Optimizer,Pose}Parameters/, runconf.conf}; per frame:
tracking, then every ``mapping_every_frame`` frames a mapping call (with BA
in its last iterations), checkpoints every ``checkpoint_freq`` frames. The
prepass density cache is rebuilt before every tracked frame and every
``prepass_cache_refresh`` mapping iterations when the conf's
``prepass_mode`` is ``cached``; with the exact prepass (the default) no
cache exists and every render evaluates the SDF network at its prepass
samples. A visualisation hook
(``utils.plots.vis_hook``) runs at the start of every ``plot_freq``-th
frame's mapping call (after frame 1, every ``SLAM.mapping.inner_freq``
iterations) and once after the last frame; it renders a full frame
(``render_full_image``) and writes panels and a mesh under ``vis/``.
"""

from __future__ import annotations

import os
import time
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import config as config_mod
from ..models import scene_model as sm
from ..models.fields import init_implicit_lins
from ..models.linear import WNLinear
from ..models.losses import loss_config_from_conf
from ..ops import hash_encoder as he
from ..utils.camera import (camera_from_tensor_np, clamp_pose_to_anchor_np,
                            tensor_from_camera_np)
from ..utils.profiling import PhaseTimer
from . import checkpoint as ckpt
from .frame_store import FrameStore
from .keyframes import KeyframeConfig, KeyframeSelector
from .mapping import (MapBatchRefs, MapConfig, make_map_draws, map_step,
                      slot_confidence)
from .state import OptimConfig, make_optimizer
from .tracking import TrackConfig, track_frame


def get_class(path: str):
    """Dynamic class loading by dotted string, with the reference package's
    dataset class mapped onto this package's."""
    aliases = {
        "datasets.scene_dataset.SLAMDataset":
            "nicer_slam_tpu_torch.datasets.scene_dataset.SLAMDataset",
        "nicer_slam_tpu.datasets.scene_dataset.SLAMDataset":
            "nicer_slam_tpu_torch.datasets.scene_dataset.SLAMDataset",
    }
    path = aliases.get(path, path)
    parts = path.split(".")
    mod = __import__(".".join(parts[:-1]), fromlist=[parts[-1]])
    return getattr(mod, parts[-1])


class SLAMRunner:
    def __init__(self, conf: str, expname: str = "", exps_folder_name: str = "exps",
                 is_continue: bool = False, timestamp: str = "latest",
                 new_expfolder: bool = False, checkpoint: str = "latest",
                 scan_id: int = -1, root_dir: str = ".", seed: int = 0,
                 quiet: bool = False, device="cuda"):
        self.device = torch.device(device)
        self.conf_path = conf
        self.conf = config_mod.parse_file(conf)
        c = self.conf
        self.quiet = quiet

        self.n_images = c.get_int("dataset.n_images")
        self.scan_id = scan_id if scan_id != -1 else c.get_int("dataset.scan_id", -1)
        self.mapping_window_size = c.get_int("SLAM.mapping.mapping_window_size")
        self.keyframe_every = c.get_int("SLAM.mapping.keyframe_every")
        self.mapping_every_frame = c.get_int("SLAM.mapping.mapping_every_frame")
        self.num_mapping_iters = c.get_int("SLAM.mapping.iters")
        self.num_cam_iters = c.get_int("SLAM.tracking.iters")
        self.enable_BA = c.get_bool("SLAM.mapping.BA")
        self.BA_ratio = c.get_float("SLAM.mapping.BA_ratio", 0.7)
        self.BA_end_ratio = c.get_float("SLAM.mapping.BA_end_ratio", 1.0)
        self.pose_graph_propagate = c.get_bool("SLAM.mapping.pose_graph_propagate", False)
        self.BA_trust_radius = c.get_float("SLAM.mapping.BA_trust_radius", 0.0)
        self.BA_trust_rot_deg = c.get_float("SLAM.mapping.BA_trust_rot_deg", 0.0)
        self._ba_anchor: Dict[int, np.ndarray] = {}
        self.conf_weight = c.get_bool("SLAM.mapping.conf_weight", False)
        self.conf_floor = c.get_float("SLAM.mapping.conf_floor", 0.3)
        self.conf_recency_kf = c.get_float("SLAM.mapping.conf_recency_kf", 2.0)
        self.conf_residual_beta = c.get_float("SLAM.mapping.conf_residual_beta", 0.0)
        self.track_residual: Dict[int, float] = {}
        self.gt_cam = c.get_bool("SLAM.tracking.gt_cam", False)
        self.const_speed = c.get_bool("SLAM.tracking.const_speed_assumption", False)
        self.verbose = c.get_bool("SLAM.verbose", False)
        self.checkpoint_freq = c.get_int("train.checkpoint_freq", 100)
        self.plot_freq = c.get_int("train.plot_freq", 50)
        self.mapping_inner_freq = c.get_int("SLAM.mapping.inner_freq", 1000)
        self.split_n_pixels = c.get_int("train.split_n_pixels", 10000)

        # ---- experiment dir layout (volsdf_train.py:66-92)
        self.expname = c.get_string("train.expname") + expname
        if self.scan_id != -1:
            self.expname = f"{self.expname}_{self.scan_id}"
        exps_root = os.path.join(root_dir, exps_folder_name)
        self.expdir = os.path.join(exps_root, self.expname)
        os.makedirs(self.expdir, exist_ok=True)
        resolved, resumed = None, False
        if is_continue and timestamp == "latest":
            # newest run dir that has a checkpoint (an aborted run leaves an
            # empty timestamp dir that must not win "latest")
            for stamp in reversed(sorted(os.listdir(self.expdir))):
                if os.path.exists(os.path.join(self.expdir, stamp, "checkpoints",
                                               "ModelParameters", "latest.npz")):
                    resolved, resumed = stamp, True
                    break
        elif is_continue:
            resolved, resumed = timestamp, True
        self.timestamp = "{:%Y_%m_%d_%H_%M_%S}".format(datetime.now())
        self.timestamp += c.get_string("train.folder_suffix", "")
        if resumed and not new_expfolder:
            self.timestamp = resolved
        self.rundir = os.path.join(self.expdir, self.timestamp)
        self.plots_dir = os.path.join(self.rundir, "vis")
        self.checkpoints_path = os.path.join(self.rundir, "checkpoints")
        os.makedirs(self.plots_dir, exist_ok=True)
        for sub in ("ModelParameters", "OptimizerParameters", "PoseParameters"):
            os.makedirs(os.path.join(self.checkpoints_path, sub), exist_ok=True)
        with open(self.conf_path) as f:
            conf_text = f.read()
        with open(os.path.join(self.rundir, "runconf.conf"), "w") as f:
            f.write(conf_text)

        # ---- dataset
        ds_cls = get_class(c.get_string("train.dataset_class",
                                        "datasets.scene_dataset.SLAMDataset"))
        ds_conf = c.get_config("dataset").as_plain_dict()
        ds_conf["scan_id"] = self.scan_id
        self.dataset = ds_cls(keyframe_every=self.keyframe_every, **ds_conf)
        self.H, self.W = self.dataset.img_res
        self.total_pixels = self.H * self.W

        # ---- model (same numpy init stream as the reference package)
        self.scene_cfg = sm.scene_config_from_conf(c.get_config("model"),
                                                   self.dataset.img_res, self.n_images)
        self.model = sm.SceneModel(self.scene_cfg, np.random.default_rng(seed))
        self._init_fine_mlp(c, conf, root_dir, seed)
        self.model.to(self.device)
        self.voxels = sm.init_voxels(self.scene_cfg, self.device)

        full_depth_mask = ("Replica" in c.get_string("dataset.data_dir")
                           and self.scan_id == 4)
        self.loss_cfg = loss_config_from_conf(c.get_config("loss"),
                                              full_depth_mask=full_depth_mask)
        self.tracking_loss_cfg = loss_config_from_conf(c.get_config("tracking_loss"))

        self.optim_cfg = OptimConfig(
            learning_rate=c.get_float("train.learning_rate"),
            learning_rate_beta=c.get_float("train.learning_rate_beta", 2e-3),
            lr_factor_for_fine_grid=c.get_float("train.lr_factor_for_fine_grid", 1.0),
            lr_factor_for_coarse_grid=c.get_float("train.lr_factor_for_coarse_grid", 1.0),
            lr_factor_for_color_grid=c.get_float("train.lr_factor_for_color_grid", 1.0),
        )
        self.optimizer = make_optimizer(self.optim_cfg, self.model)

        self.track_cfg = TrackConfig(
            num_iters=self.num_cam_iters,
            num_pixels=c.get_int("train.tracking_num_pixels", 1024),
            cam_lr=c.get_float("SLAM.tracking.lr"),
            Hedge=c.get_int("SLAM.tracking.Hedge", 0),
            Wedge=c.get_int("SLAM.tracking.Wedge", 0),
            lr_step_size=c.get_int("SLAM.tracking.lr_step_size", 50),
            lr_gamma=c.get_float("SLAM.tracking.lr_gamma", 0.95),
            rot_lr_scale=c.get_float("SLAM.tracking.rot_lr_scale", 1.0),
            motion_prior_w=c.get_float("SLAM.tracking.motion_prior_w", 0.0),
            motion_prior_rot_w=c.get_float("SLAM.tracking.motion_prior_rot_w", 0.0),
            motion_prior_spring=c.get_float("SLAM.tracking.motion_prior_spring", 0.0),
        )
        gws = c.get_int("SLAM.mapping.global_window_start", 200)
        local_worst = max(gws // self.keyframe_every + 1,
                          2 * self.mapping_window_size // 3 + 1)
        self.map_cfg = MapConfig(
            num_pixels=c.get_int("train.mapping_num_pixels", 8192),
            max_slots=self.mapping_window_size // 3 + local_worst + self.keyframe_every,
            BA_cam_lr=c.get_float("SLAM.mapping.BA_cam_lr", 1e-3),
        )
        self.max_edges = 96
        self.kf_selector = KeyframeSelector(
            KeyframeConfig(self.mapping_window_size, self.keyframe_every,
                           self.num_mapping_iters, global_window_start=gws),
            seed=seed)

        self.store = FrameStore(self.H, self.W, self.n_images // self.keyframe_every + 2,
                                n_recent_rows=self.keyframe_every + 2,
                                device=self.device)
        self.start_frame_idx = 0
        self.est_pose_all: Dict[int, np.ndarray] = self.dataset.est_pose_all
        # bounded host-side cache of loaded flow pairs
        self._flow_cache: Dict = {}
        self._flow_cache_max = 64
        self._edge_refs = None
        self._use_flow = bool(self.loss_cfg.flow_weight > 0
                              and os.path.isdir(getattr(self.dataset, "flow_dir", "")))
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.timer = PhaseTimer(self.device)
        self.beta_warmup_scale = c.get_float("model.density.beta_warmup_scale", 0.0)
        self.beta_warmup_iters = c.get_int("model.density.beta_warmup_iters", 50)
        self.prepass_refresh = c.get_int("model.ray_sampler.prepass_cache_refresh", 10)
        self.density_cache = self._refresh_cache()
        self.last_map_terms = None
        if resumed:
            self._restore(checkpoint)

    # ------------------------------------------------------------------
    def _init_fine_mlp(self, c, conf: str, root_dir: str, seed: int):
        """Pretrained fine-MLP weights (pretrain.npz), else the reference
        package's fallback: geometric init with live grid columns."""
        pretrain = c.get_string("train.pretrain_path", "pretrain.npz")
        if not os.path.isabs(pretrain):
            pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            for base in (root_dir, os.path.dirname(os.path.abspath(conf)), pkg,
                         os.path.dirname(pkg)):
                cand = os.path.join(base, pretrain)
                if os.path.exists(cand):
                    pretrain = cand
                    break
        lins = self.model.implicit.fine.lins
        if os.path.exists(pretrain):
            with np.load(pretrain) as data:
                loaded = {(i, k): data[f"fine_lin{i}_{k}"]
                          for i, lin in enumerate(lins)
                          for k, _ in lin.named_parameters()
                          if f"fine_lin{i}_{k}" in data.files}
            shapes_ok = all(v.shape == tuple(getattr(lins[i], k).shape)
                            for (i, k), v in loaded.items())
            if not shapes_ok:
                self.log(f"[warn] pretrain {pretrain} shapes differ from the fine "
                         f"MLP; skipping pretrain")
            if loaded and shapes_ok:
                with torch.no_grad():
                    for (i, k), v in loaded.items():
                        getattr(lins[i], k).copy_(torch.from_numpy(v))
                self.log(f"loaded pretrained fine MLP: {pretrain}")
                return
        fine_cfg = self.scene_cfg.combine.fine._replace(geometric_init=True)
        rng_fb = np.random.default_rng(seed + 1)
        he.init_hash_params(rng_fb, fine_cfg.hash_spec())  # keeps the stream aligned
        geo = init_implicit_lins(rng_fb, fine_cfg)
        v = geo[0]["v"].copy()
        n_pe = 3 * (1 + 2 * fine_cfg.multires)
        v[:, n_pe:] = rng_fb.normal(0.0, 0.05, v[:, n_pe:].shape).astype(np.float32)
        geo[0]["v"] = v
        if "g" in geo[0]:
            geo[0]["g"] = np.linalg.norm(v, axis=1, keepdims=True).astype(np.float32)
        self.model.implicit.fine.lins = torch.nn.ModuleList(WNLinear(p) for p in geo)
        self.log("[warn] no pretrain.npz found — geometric fine-MLP fallback")

    def log(self, *args):
        if not self.quiet:
            print(*args, flush=True)

    def _refresh_cache(self) -> Optional[torch.Tensor]:
        """A fresh prepass density cache; None with the exact prepass."""
        if self.scene_cfg.sampler.prepass_mode != "cached":
            return None
        with self.timer.phase("cache"):
            return sm.build_density_cache(self.scene_cfg, self.model, self.voxels)

    # ------------------------------------------------------------------
    def save_checkpoints(self, frame_idx: int):
        with self.timer.phase("checkpoint"):
            ckpt.save_model(os.path.join(self.checkpoints_path, "ModelParameters"),
                            self.model, self.voxels, frame_idx)
            ckpt.save_optimizer(os.path.join(self.checkpoints_path, "OptimizerParameters"),
                                self.model, self.optimizer, frame_idx)
            ckpt.save_poses(os.path.join(self.checkpoints_path, "PoseParameters"),
                            self.est_pose_all, self.dataset.gt_pose_all, frame_idx)

    def _restore(self, checkpoint: str = "latest"):
        mp = os.path.join(self.checkpoints_path, "ModelParameters")
        if not os.path.exists(os.path.join(mp, f"{checkpoint}.npz")):
            return
        voxels, self.start_frame_idx = ckpt.load_model(mp, self.model, checkpoint)
        self.voxels = torch.from_numpy(voxels).to(self.device)
        op = os.path.join(self.checkpoints_path, "OptimizerParameters")
        if os.path.exists(os.path.join(op, f"{checkpoint}.npz")):
            ckpt.load_optimizer(op, self.model, self.optimizer, checkpoint)
        est, _, _ = ckpt.load_poses(os.path.join(self.checkpoints_path, "PoseParameters"),
                                    checkpoint)
        self.est_pose_all.update(est)
        self.density_cache = self._refresh_cache()
        self.log(f"Resuming from frame_idx: {self.start_frame_idx}")

    # ------------------------------------------------------------------
    def _stage_frame(self, frame_idx: int):
        if frame_idx in self.store:
            return
        data = self.dataset.frame(frame_idx)
        self.store.put(frame_idx, rgb=data["rgb"], depth=data["depth"],
                       normal=data["normal"], gt_depth=data["gt_depth"],
                       mask=data["mask"],
                       is_keyframe=(frame_idx % self.keyframe_every == 0))
        self.dataset.clean(frame_idx)

    def track(self, frame_idx: int) -> np.ndarray:
        """Track one frame; returns the estimated c2w (4x4 numpy)."""
        gt_c2w = self.dataset.gt_pose_all[frame_idx]
        if frame_idx == 0 or self.gt_cam:
            self.est_pose_all[frame_idx] = np.asarray(gt_c2w)
            return np.asarray(gt_c2w)
        if self.const_speed and frame_idx - 2 >= 0:
            delta = (self.est_pose_all[frame_idx - 1]
                     @ np.linalg.inv(self.est_pose_all[frame_idx - 2]))
            init_c2w = delta @ self.est_pose_all[frame_idx - 1]
        else:
            init_c2w = self.est_pose_all[frame_idx - 1]
        init_q = torch.from_numpy(tensor_from_camera_np(init_c2w)).to(self.device)
        # fresh sample-placement cache: the map moved in the last mapping call
        self.density_cache = self._refresh_cache()
        self._stage_frame(frame_idx)
        row = self.store.row(frame_idx)
        K = torch.from_numpy(self.dataset.intrinsics_all[frame_idx]).to(self.device)
        with self.timer.phase("tracking"):
            best_q, _, aux = track_frame(
                self.scene_cfg, self.track_cfg, self.tracking_loss_cfg, self.model,
                self.voxels, self.store.rgb[row], K, init_q, self.gen,
                self.density_cache)
        c2w = camera_from_tensor_np(best_q.cpu().numpy())
        self.est_pose_all[frame_idx] = c2w
        self.track_residual[frame_idx] = float(aux["best_loss"])
        if self.verbose:
            losses = aux["losses"].cpu().numpy()
            err_t = float(np.linalg.norm(gt_c2w[:3, 3] - c2w[:3, 3]))
            self.log(f"[track {frame_idx}] loss {losses[0]:.4f}->{losses[-1]:.4f} "
                     f"trans err {err_t:.4f}")
        return c2w

    # ------------------------------------------------------------------
    def _load_flow_pair(self, i: int, j: int):
        """Flow + usable mask for edge i->j as [HW,2] f16 / [HW] bool, from a
        bounded cross-call cache. Masked flow is zeroed (and the rest
        clipped) BEFORE the f16 cast: geometric flow is unbounded at
        unusable pixels and would overflow to inf."""
        key = (i, j)
        if key in self._flow_cache:
            return self._flow_cache[key]
        try:
            flow, ok = self.dataset.flow_pair(i, j)
        except (FileNotFoundError, AttributeError):
            return None
        flow = flow.reshape(self.total_pixels, 2)
        ok = ok.reshape(self.total_pixels)
        flow = np.where(ok[:, None], np.clip(np.nan_to_num(flow), -6.0e4, 6.0e4), 0.0)
        entry = (flow.astype(np.float16), ok)
        if len(self._flow_cache) >= self._flow_cache_max:
            self._flow_cache.pop(next(iter(self._flow_cache)))
        self._flow_cache[key] = entry
        return entry

    def _prepare_edge_refs(self, edges):
        """Flow-edge device data for one mapping call: only the edges whose
        flow loaded (at most max_edges)."""
        self._edge_refs = None
        if not self._use_flow or edges is None:
            return
        idii, idjj, ii, jj = edges
        kept = []
        for e in range(min(len(idii), self.max_edges)):
            pair = self._load_flow_pair(int(ii[e]), int(jj[e]))
            if pair is not None:
                kept.append((int(idii[e]), int(idjj[e]), pair))
        if not kept:
            return
        dev = self.device
        self._edge_refs = (
            torch.tensor([k[0] for k in kept], dtype=torch.int64, device=dev),
            torch.tensor([k[1] for k in kept], dtype=torch.int64, device=dev),
            torch.from_numpy(np.stack([k[2][0] for k in kept])).to(dev),
            torch.from_numpy(np.stack([k[2][1] for k in kept])).to(dev))

    def _prepare_refs(self, keyframe_list: List[int], frame_idx: int) -> MapBatchRefs:
        Smax = self.map_cfg.max_slots
        kfs = keyframe_list[:Smax]
        for kf in kfs:
            self._stage_frame(kf)
        slot_rows = np.zeros((Smax,), np.int64)
        frame_ids = np.zeros((Smax,), np.int64)
        intr = np.tile(np.eye(4, dtype=np.float32)[None], (Smax, 1, 1))
        for s, kf in enumerate(kfs):
            slot_rows[s] = self.store.row(kf)
            frame_ids[s] = kf
            intr[s] = self.dataset.intrinsics_all[kf]
        if self.conf_weight:
            slot_conf = slot_confidence(kfs, frame_idx, Smax, self.keyframe_every,
                                        self.track_residual, floor=self.conf_floor,
                                        recency_kf=self.conf_recency_kf,
                                        residual_beta=self.conf_residual_beta)
        else:
            slot_conf = np.ones((Smax,), np.float32)
        edge = self._edge_refs or (None, None, None, None)
        dev = self.device
        return MapBatchRefs(
            slot_rows=torch.from_numpy(slot_rows).to(dev),
            frame_ids=torch.from_numpy(frame_ids).to(dev),
            n_valid=len(kfs),
            intrinsics=torch.from_numpy(intr).to(dev),
            edge_idii=edge[0], edge_idjj=edge[1], flow_imgs=edge[2], flow_occ=edge[3],
            slot_conf=torch.from_numpy(slot_conf).to(dev))

    def map(self, frame_idx: int, vis_hook=None):
        """One full mapping call (num_mapping_iters iterations); its last
        iteration's loss terms are kept in ``last_map_terms``."""
        self.last_map_terms = self._map_impl(frame_idx, vis_hook)
        return self.last_map_terms

    def _map_impl(self, frame_idx: int, vis_hook=None):
        Smax = self.map_cfg.max_slots
        ba_snapshot: Dict[int, np.ndarray] = {}
        terms = None
        for mapping_iter in range(self.num_mapping_iters):
            # mid-mapping visual observability (volsdf_train.py:531-536);
            # with the default inner_freq 1000 it fires once, at iteration 0
            if (vis_hook is not None and frame_idx > 1
                    and mapping_iter % self.mapping_inner_freq == 0
                    and frame_idx % self.plot_freq == 0):
                with self.timer.phase("vis"):
                    vis_hook(self, frame_idx, inner_iter=mapping_iter)
            win = self.kf_selector.window(frame_idx, mapping_iter)
            kfs = win.keyframe_list[:Smax]
            ba = (self.enable_BA and frame_idx > 0
                  and mapping_iter > int(self.num_mapping_iters * self.BA_ratio)
                  and mapping_iter <= int(self.num_mapping_iters * self.BA_end_ratio))
            if mapping_iter == 0:
                self._prepare_edge_refs(win.edges)
            refs = self._prepare_refs(kfs, frame_idx)

            poses_q = np.zeros((Smax, 7), np.float32)
            poses_q[:, 0] = 1.0
            for s, kf in enumerate(kfs):
                src = (self.dataset.gt_pose_all[kf] if ba and kf == 0
                       else self.est_pose_all.get(kf, self.dataset.gt_pose_all[kf]))
                poses_q[s] = tensor_from_camera_np(src)

            if frame_idx > 1:
                stage = ("coarse" if mapping_iter < int(self.num_mapping_iters * 0.25)
                         else "fine")
                color_stage = ("base" if mapping_iter < int(self.num_mapping_iters * 0.7)
                               else "highfreq")
            else:
                stage, color_stage = "fine", "highfreq"
            beta_scale = None
            if self.beta_warmup_scale > 0 and frame_idx == 0:
                frac = min(mapping_iter / max(self.beta_warmup_iters, 1), 1.0)
                beta_scale = float(np.float32(self.beta_warmup_scale ** (1.0 - frac)))
            if mapping_iter % self.prepass_refresh == 0:
                self.density_cache = self._refresh_cache()
            with self.timer.phase("mapping"):
                self.voxels, new_q, terms = map_step(
                    self.scene_cfg, self.map_cfg, self.loss_cfg, self.model,
                    self.optimizer, self.voxels,
                    torch.from_numpy(poses_q).to(self.device), refs, self.store.data(),
                    make_map_draws(self.scene_cfg, self.map_cfg, self.gen, self.device),
                    self.density_cache, beta_scale, stage=stage,
                    color_stage=color_stage, ba=ba, is_first_frame=(frame_idx == 0))

            if ba:
                new_q = new_q.cpu().numpy()
                for s, kf in enumerate(kfs):
                    if kf == 0:
                        self.est_pose_all[kf] = np.asarray(self.dataset.gt_pose_all[kf])
                    elif win.writeback_eligible[s]:
                        if kf not in ba_snapshot and kf in self.est_pose_all:
                            ba_snapshot[kf] = np.asarray(self.est_pose_all[kf]).copy()
                        new_c2w = camera_from_tensor_np(new_q[s])
                        if self.BA_trust_radius > 0 or self.BA_trust_rot_deg > 0:
                            if kf not in self._ba_anchor:
                                self._ba_anchor[kf] = np.asarray(
                                    self.est_pose_all.get(kf, new_c2w)).copy()
                            new_c2w = clamp_pose_to_anchor_np(
                                new_c2w, self._ba_anchor[kf], self.BA_trust_radius,
                                self.BA_trust_rot_deg)
                        self.est_pose_all[kf] = new_c2w
            if self.verbose and mapping_iter % 20 == 0:
                self.log(f"[map {frame_idx}:{mapping_iter}] loss {float(terms['loss']):.4f} "
                         f"rgb {float(terms['rgb_loss']):.4f} "
                         f"eik {float(terms['eikonal_loss']):.4f}")
        if self.pose_graph_propagate and ba_snapshot:
            self._propagate_ba_corrections(ba_snapshot)
        return terms

    def _propagate_ba_corrections(self, ba_snapshot: Dict[int, np.ndarray]):
        """Frames BA never touched get the world-frame correction of their
        nearest preceding BA-corrected keyframe."""
        corrected = sorted(ba_snapshot.keys())
        deltas = {kf: np.asarray(self.est_pose_all[kf]) @ np.linalg.inv(ba_snapshot[kf])
                  for kf in corrected}
        for j in sorted(self.est_pose_all.keys()):
            if j in deltas or j == 0:
                continue
            k0 = max((kf for kf in corrected if kf <= j), default=None)
            if k0 is not None:
                self.est_pose_all[j] = deltas[k0] @ np.asarray(self.est_pose_all[j])

    # ------------------------------------------------------------------
    def run(self, vis_hook=None, frame_hook=None):
        """Main SLAM loop. ``vis_hook(runner, frame_idx, inner_iter=0)``
        fires inside plot_freq-aligned mapping calls and after the last
        frame; ``frame_hook(runner, frame_idx)`` fires after each frame's
        track(+map). ``run_s`` holds the loop's wall time and ``timer`` its
        phases."""
        self.log("running...")
        self.timer = PhaseTimer(self.device)
        t0 = time.time()
        frame_idx = self.start_frame_idx
        for frame_idx in range(self.start_frame_idx, self.n_images):
            if frame_idx % self.checkpoint_freq == 0 and frame_idx != 0:
                self.save_checkpoints(frame_idx)
            with self.timer.phase("frames"):
                self._stage_frame(frame_idx)
            self.track(frame_idx)
            if frame_idx % self.mapping_every_frame == 0:
                self.map(frame_idx, vis_hook=vis_hook)
            if frame_hook is not None:
                frame_hook(self, frame_idx)
            if not self.quiet and frame_idx % 10 == 0:
                dt = time.time() - t0
                self.log(f"frame {frame_idx}/{self.n_images} ({dt:.1f}s, "
                         f"{dt / max(frame_idx - self.start_frame_idx + 1, 1):.2f}s/frame)")
        self.save_checkpoints(frame_idx)
        if vis_hook is not None:
            with self.timer.phase("vis"):
                vis_hook(self, frame_idx)
        self.run_s = time.time() - t0
        self.log("phase timings: " + self.timer.report())

    # ------------------------------------------------------------------
    def render_full_image(self, frame_idx: int, pose: Optional[np.ndarray] = None,
                          chunk: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Render a full frame with the frame's intrinsics at ``pose`` (by
        default its estimated pose, GT before it has one) in chunks of
        ``chunk`` rays (default ``split_n_pixels``), with the exact
        prepass. The render draws nothing, so the JAX runner's ``key`` has
        no counterpart here."""
        from .render import render_image

        c2w = pose if pose is not None else self.est_pose_all.get(
            frame_idx, self.dataset.gt_pose_all[frame_idx])
        return render_image(self.scene_cfg, self.model, self.voxels, np.asarray(c2w),
                            np.asarray(self.dataset.intrinsics_all[frame_idx]),
                            frame_idx=frame_idx, chunk=chunk or self.split_n_pixels)
