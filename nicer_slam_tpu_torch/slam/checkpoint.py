"""Checkpoint/resume with the reference package's on-disk contract
(counterpart of nicer_slam_tpu/slam/checkpoint.py).

  checkpoints/ModelParameters/latest.npz      model_state_dict/<param path>,
                                              voxels, frame_idx
  checkpoints/OptimizerParameters/latest.npz  leaf_<i>, keypaths, frame_idx
  checkpoints/PoseParameters/latest.npz       est_keys, est_poses, gt_poses,
                                              frame_idx

The model and pose files are interchangeable with the JAX package's: param
paths are the JAX pytree paths (``implicit/coarse/lins/0/v``), which are
the module's state_dict keys with '.' replaced by '/'. The hash-grid tables
(``.../encoding``) are ``[T, C]`` in this package and ``[C, T]`` in the
files, as the JAX package holds them: ``jax_layout``/``port_layout``
transpose at this boundary, for the model file and the Adam moments alike.

The optimizer file is the JAX package's too: the leaves of its optax state
(``optax.multi_transform`` over ``state.ADAM_GROUPS`` and the frozen
group) in jax's flatten order as ``leaf_<i>``, and ``keypaths``, the
strings ``jax.tree_util.keystr`` gives them (``_opt_state_keypaths``). Per
group, in name order: its Adam ``count`` (int32), then ``mu`` and ``nu``
over the group's parameters in the tree's order (dict keys sorted, lists
by index); the frozen group keeps no state, and an Adam group without
parameters keeps its count. A torch Adam group is the same Adam (every
parameter steps on every update, ``state.fill_missing_grads``), so its
parameters' ``step`` is the group's count. Files of the port's earlier
layout (``<param path>/{step,exp_avg,exp_avg_sq}``) still load.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from .state import ADAM_GROUPS

_PREFIX = "model_state_dict/"


def _is_table(path: str) -> bool:
    return path.rsplit("/", 1)[-1] == "encoding"


def jax_layout(path: str, t: torch.Tensor) -> np.ndarray:
    """The array at JAX param path ``path`` (a parameter, its gradient or an
    Adam moment) in the JAX package's layout: tables transposed to
    ``[C, T]`` (on the tensor's device, before the copy to the host)."""
    t = t.detach()
    return (t.t().contiguous() if _is_table(path) else t).cpu().numpy()


def port_layout(path: str, a: np.ndarray) -> torch.Tensor:
    """Inverse of ``jax_layout``: a host tensor in this package's layout."""
    t = torch.from_numpy(np.require(a, requirements=["C", "W"]))
    return t.t().contiguous() if _is_table(path) else t


def params_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """Module parameters -> {JAX param path: array} (what the JAX package's
    ``_flatten_pytree(params)`` makes, tables ``[C, T]``)."""
    return {path: jax_layout(path, v) for path, v in
            ((k.replace(".", "/"), v) for k, v in model.state_dict().items())}


def params_from_numpy(flat: Dict[str, np.ndarray], model: torch.nn.Module):
    """Load {JAX param path: array} (optionally ``model_state_dict/``-
    prefixed, as in a ModelParameters npz) into ``model`` in place."""
    state = {}
    for k, v in flat.items():
        if k.startswith(_PREFIX):
            k = k[len(_PREFIX):]
        elif "/" not in k and k in ("voxels", "frame_idx"):
            continue
        state[k.replace("/", ".")] = port_layout(k, v)
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


def _tree_key(path: str):
    """Sort key of a param path in jax's flatten order: dict keys as
    strings, list indices as numbers."""
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c) for c in path.split("/"))


def keystr(path: str) -> str:
    """``jax.tree_util.keystr`` of a param path: ``implicit/coarse/lins/0/v``
    -> ``['implicit']['coarse']['lins'][0]['v']``."""
    return "".join(f"[{c}]" if c.isdigit() else f"['{c}']" for c in path.split("/"))


def optax_layout(model: torch.nn.Module, optimizer: torch.optim.Optimizer
                 ) -> List[Tuple[str, str, str, object]]:
    """The JAX package's optimizer state, leaf by leaf in its flatten
    order: (keypath, group, field, param) with field ``count`` (param None),
    ``mu`` or ``nu`` (param: (path, tensor))."""
    names = {id(p): n.replace(".", "/") for n, p in model.named_parameters()}
    by_group = {g.get("name"): [(names[id(p)], p) for p in g["params"]]
                for g in optimizer.param_groups}
    unknown = set(by_group) - set(ADAM_GROUPS)
    if unknown:
        raise ValueError(f"optimizer groups {sorted(unknown)} are not the JAX package's "
                         f"{ADAM_GROUPS}")
    out = []
    for group in sorted(ADAM_GROUPS):
        pre = f".inner_states['{group}'].inner_state[0]"
        out.append((f"{pre}.count", group, "count", None))
        params = sorted(by_group.get(group, []), key=lambda t: _tree_key(t[0]))
        for field in ("mu", "nu"):
            out += [(f"{pre}.{field}{keystr(path)}", group, field, (path, p))
                    for path, p in params]
    return out


def _count(optimizer: torch.optim.Optimizer) -> int:
    """Adam updates taken: every group's count, since every parameter steps
    on every update."""
    steps = {int(st["step"]) for st in optimizer.state.values() if "step" in st}
    if len(steps) > 1:
        raise ValueError(f"Adam groups at different step counts {sorted(steps)}: the JAX "
                         f"package's optax state keeps one count per group, all equal")
    return steps.pop() if steps else 0


def save_optimizer(path_dir: str, model: torch.nn.Module,
                   optimizer: torch.optim.Optimizer, frame_idx: int):
    """The Adam state in the JAX package's optax layout (``leaf_<i>``,
    ``keypaths``, ``frame_idx``)."""
    os.makedirs(path_dir, exist_ok=True)
    count = _count(optimizer)
    flat, keys = {}, []
    for i, (key, _, field, param) in enumerate(optax_layout(model, optimizer)):
        keys.append(key)
        if field == "count":
            flat[f"leaf_{i}"] = np.asarray(count, np.int32)
            continue
        path, p = param
        st = optimizer.state.get(p, {})
        moment = st.get("exp_avg" if field == "mu" else "exp_avg_sq")
        flat[f"leaf_{i}"] = (jax_layout(path, moment) if moment is not None
                             else jax_layout(path, torch.zeros_like(p)))
    flat["frame_idx"] = np.asarray(frame_idx)
    flat["keypaths"] = np.asarray(keys)
    np.savez(os.path.join(path_dir, "latest.npz"), **flat)


def load_optimizer(path_dir: str, model: torch.nn.Module,
                   optimizer: torch.optim.Optimizer, checkpoint: str = "latest") -> None:
    """Restore Adam state from a file in the JAX package's optax layout
    (either package's), or in the port's earlier layout. Raises
    ValueError, as the JAX package's reader does, when the saved keypaths
    or a leaf's shape differ from this optimizer's."""
    with np.load(os.path.join(path_dir, f"{checkpoint}.npz")) as data:
        flat = {k: data[k] for k in data.files}
    if "keypaths" in flat:
        _load_optax(flat, model, optimizer)
        return
    for name, p in _param_paths(model, optimizer):
        keys = [k for k in flat if k.startswith(name + "/")]
        if not keys:
            continue
        state = {}
        for k in keys:
            field = k[len(name) + 1:]
            v = (torch.from_numpy(flat[k]) if field == "step"
                 else port_layout(name, flat[k]))
            if field != "step" and tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"optimizer state {k}: shape {tuple(v.shape)} "
                                 f"!= {tuple(p.shape)}")
            state[field] = v.to(p.device) if field != "step" else v.to(torch.float32)
        optimizer.state[p] = state


def _load_optax(flat: Dict[str, np.ndarray], model: torch.nn.Module,
                optimizer: torch.optim.Optimizer) -> None:
    layout = optax_layout(model, optimizer)
    saved = [str(k) for k in flat["keypaths"]]
    current = [key for key, *_ in layout]
    if saved != current:
        first = next((f"{a} != {b}" for a, b in zip(saved, current) if a != b), "leaf count")
        raise ValueError(
            "optimizer checkpoint structure mismatch (optimizer config or param tree "
            "changed since save); refusing to restore misaligned Adam state. saved "
            f"{len(saved)} leaves vs current {len(current)}; first difference: {first}")
    counts, moments = {}, {}
    for i, (key, group, field, param) in enumerate(layout):
        leaf = flat[f"leaf_{i}"]
        if field == "count":
            counts[group] = int(leaf)
            continue
        path, p = param
        want = tuple(p.shape[::-1]) if _is_table(path) else tuple(p.shape)
        if tuple(leaf.shape) != want:
            raise ValueError(f"optimizer checkpoint leaf_{i} ({key}) shape {leaf.shape} != "
                             f"expected {want}")
        st = moments.setdefault(p, {"step": group})
        st["exp_avg" if field == "mu" else "exp_avg_sq"] = port_layout(path, leaf).to(p.device)
    for p, st in moments.items():
        count = counts[st["step"]]
        if count > 0:
            optimizer.state[p] = dict(st, step=torch.tensor(float(count), dtype=torch.float32))
        else:
            optimizer.state.pop(p, None)


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
