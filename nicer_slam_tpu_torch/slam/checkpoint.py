"""Checkpoint/resume with the reference package's on-disk contract
(counterpart of nicer_slam_tpu/slam/checkpoint.py).

  checkpoints/ModelParameters/latest.npz      model_state_dict/<param path>,
                                              voxels, frame_idx
  checkpoints/OptimizerParameters/latest.npz  this package's own layout
  checkpoints/PoseParameters/latest.npz       est_keys, est_poses, gt_poses,
                                              frame_idx

The model and pose files are interchangeable with the JAX package's: param
paths are the JAX pytree paths (``implicit/coarse/lins/0/v``), which are
the module's state_dict keys with '.' replaced by '/'. The optimizer file
holds torch Adam state keyed by the same paths; reading the JAX package's
optax state is not supported.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

_PREFIX = "model_state_dict/"


def params_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """Module parameters -> {JAX param path: array} (what the JAX package's
    ``_flatten_pytree(params)`` makes)."""
    return {k.replace(".", "/"): v.detach().cpu().numpy()
            for k, v in model.state_dict().items()}


def params_from_numpy(flat: Dict[str, np.ndarray], model: torch.nn.Module):
    """Load {JAX param path: array} (optionally ``model_state_dict/``-
    prefixed, as in a ModelParameters npz) into ``model`` in place."""
    state = {}
    for k, v in flat.items():
        if k.startswith(_PREFIX):
            k = k[len(_PREFIX):]
        elif "/" not in k and k in ("voxels", "frame_idx"):
            continue
        state[k.replace("/", ".")] = torch.from_numpy(np.require(v, requirements=["C", "W"]))
    missing = set(model.state_dict()) - set(state)
    unexpected = set(state) - set(model.state_dict())
    if missing or unexpected:
        raise ValueError(f"param tree mismatch: missing {sorted(missing)}, "
                         f"unexpected {sorted(unexpected)}")
    for k, v in model.state_dict().items():
        if tuple(state[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(state[k].shape)} != {tuple(v.shape)}")
    model.load_state_dict(state)
    return model


def save_model(path_dir: str, model: torch.nn.Module, voxels: torch.Tensor,
               frame_idx: int):
    os.makedirs(path_dir, exist_ok=True)
    flat = {_PREFIX + k: v for k, v in params_to_numpy(model).items()}
    flat["voxels"] = voxels.detach().cpu().numpy()
    flat["frame_idx"] = np.asarray(frame_idx)
    np.savez(os.path.join(path_dir, "latest.npz"), **flat)


def load_model(path_dir: str, model: torch.nn.Module, checkpoint: str = "latest"):
    """Load params into ``model``; returns (voxels numpy, frame_idx)."""
    with np.load(os.path.join(path_dir, f"{checkpoint}.npz"), allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    params_from_numpy({k: v for k, v in flat.items() if k.startswith(_PREFIX)}, model)
    return flat["voxels"], int(flat["frame_idx"])


def _param_paths(model: torch.nn.Module, optimizer: torch.optim.Optimizer):
    names = {id(p): n.replace(".", "/") for n, p in model.named_parameters()}
    return [(names[id(p)], p) for g in optimizer.param_groups for p in g["params"]]


def save_optimizer(path_dir: str, model: torch.nn.Module,
                   optimizer: torch.optim.Optimizer, frame_idx: int):
    os.makedirs(path_dir, exist_ok=True)
    flat = {"frame_idx": np.asarray(frame_idx)}
    for name, p in _param_paths(model, optimizer):
        for k, v in optimizer.state.get(p, {}).items():
            flat[f"{name}/{k}"] = (v.detach().cpu().numpy() if torch.is_tensor(v)
                                   else np.asarray(v))
    np.savez(os.path.join(path_dir, "latest.npz"), **flat)


def load_optimizer(path_dir: str, model: torch.nn.Module,
                   optimizer: torch.optim.Optimizer, checkpoint: str = "latest") -> bool:
    """Restore Adam state written by save_optimizer. Returns False, leaving
    the optimizer fresh, for a file in the JAX package's optax layout."""
    with np.load(os.path.join(path_dir, f"{checkpoint}.npz")) as data:
        flat = {k: data[k] for k in data.files}
    if "keypaths" in flat:
        return False
    for name, p in _param_paths(model, optimizer):
        keys = [k for k in flat if k.startswith(name + "/")]
        if not keys:
            continue
        state = {}
        for k in keys:
            v = torch.from_numpy(flat[k])
            field = k[len(name) + 1:]
            if field != "step" and tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"optimizer state {k}: shape {tuple(v.shape)} "
                                 f"!= {tuple(p.shape)}")
            state[field] = v.to(p.device) if field != "step" else v.to(torch.float32)
        optimizer.state[p] = state
    return True


def save_poses(path_dir: str, est_pose_all: Dict[int, np.ndarray],
               gt_pose_all: List[np.ndarray], frame_idx: int):
    os.makedirs(path_dir, exist_ok=True)
    keys = sorted(est_pose_all.keys())
    flat = {
        "frame_idx": np.asarray(frame_idx),
        "est_keys": np.asarray(keys, np.int64),
        "est_poses": np.stack([np.asarray(est_pose_all[k]) for k in keys])
        if keys else np.zeros((0, 4, 4), np.float32),
        "gt_poses": np.stack([np.asarray(p) for p in gt_pose_all])
        if len(gt_pose_all) else np.zeros((0, 4, 4), np.float32),
    }
    np.savez(os.path.join(path_dir, "latest.npz"), **flat)


def load_poses(path_dir: str, checkpoint: str = "latest"):
    with np.load(os.path.join(path_dir, f"{checkpoint}.npz")) as data:
        est = {int(k): data["est_poses"][i] for i, k in enumerate(data["est_keys"])}
        gt = [data["gt_poses"][i] for i in range(data["gt_poses"].shape[0])]
        return est, gt, int(data["frame_idx"])
