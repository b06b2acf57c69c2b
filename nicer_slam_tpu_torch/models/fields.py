"""Field networks: hash-grid SDF decoders (coarse + fine) and the color
network (counterpart of nicer_slam_tpu/models/fields.py).

Modules hold the parameters (state_dict keys = the JAX npz keys:
``encoding``, ``lins.<i>.{v,g,b}``); the functions keep the JAX package's
names and take the module. A grid's ``encoding`` is its hash table
``[T, C]``, the transpose of the JAX package's ``[C, T]``
(``slam/checkpoint.py`` converts at the file boundary).

SDF normals take the analytic route: the grid encoder returns features and
their Jacobian from one gather (K1), ``dSDF/dinput`` comes from
``torch.autograd.grad(..., create_graph=True)`` over the MLP alone, and the
chain rule contracts the two. The outer loss therefore differentiates only
the MLP twice; K1's own backward is first order.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import Config
from ..ops import hash_encoder as he
from ..ops.embedder import (positional_encoding, positional_encoding_dim,
                            positional_encoding_grad_contract)
from .linear import (WNLinear, init_linear_default, init_linear_geometric,
                     softplus_beta100)


# ---------------------------------------------------------------------------
# Implicit (SDF) network
# ---------------------------------------------------------------------------

class ImplicitNetConfig(NamedTuple):
    d_in: int = 3
    d_out: int = 1
    dims: Tuple[int, ...] = (64,)
    geometric_init: bool = True
    bias: float = 0.6
    skip_in: Tuple[int, ...] = ()
    weight_norm: bool = True
    multires: int = 6
    inside_outside: bool = True
    use_grid_feature: bool = True
    base_size: int = 32
    end_size: int = 32
    logmap: int = 19
    num_levels: int = 4
    level_dim: int = 8
    divide_factor: float = 1.0
    feature_vector_size: int = 64
    clamp: bool = False
    name: str = ""

    @property
    def grid_feature_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def layer_dims(self) -> Tuple[int, ...]:
        d0 = self.d_in + self.grid_feature_dim
        if self.multires > 0:
            d0 += positional_encoding_dim(self.multires, self.d_in) - 3
        return (d0,) + tuple(self.dims) + (self.d_out + self.feature_vector_size,)

    def hash_spec(self) -> he.HashGridSpec:
        return he.make_spec(input_dim=3, num_levels=self.num_levels,
                            level_dim=self.level_dim, per_level_scale=2.0,
                            base_resolution=self.base_size,
                            log2_hashmap_size=self.logmap,
                            desired_resolution=self.end_size)


def implicit_config_from_conf(conf: Config, feature_vector_size: int,
                              name: str = "") -> ImplicitNetConfig:
    if conf.get_bool("concat_coarse_feature", False):
        raise NotImplementedError("concat_coarse_feature is not ported yet")
    return ImplicitNetConfig(
        d_in=conf.get_int("d_in", 3),
        d_out=conf.get_int("d_out", 1),
        dims=tuple(conf.get_list("dims", [64])),
        geometric_init=conf.get_bool("geometric_init", True),
        bias=conf.get_float("bias", 1.0),
        skip_in=tuple(conf.get_list("skip_in", [])),
        weight_norm=conf.get_bool("weight_norm", True),
        multires=conf.get_int("multires", 0),
        inside_outside=conf.get_bool("inside_outside", False),
        use_grid_feature=conf.get_bool("use_grid_feature", True),
        base_size=conf.get_int("base_size", 16),
        end_size=conf.get_int("end_size", 2048),
        logmap=conf.get_int("logmap", 19),
        num_levels=conf.get_int("num_levels", 16),
        level_dim=conf.get_int("level_dim", 2),
        divide_factor=conf.get_float("divide_factor", 1.5),
        feature_vector_size=feature_vector_size,
        clamp=conf.get_bool("clamp", False),
        name=name,
    )


def init_implicit_lins(rng: np.random.Generator, cfg: ImplicitNetConfig):
    dims = cfg.layer_dims
    num_layers = len(dims)
    lins = []
    for l in range(num_layers - 1):
        out_dim = dims[l + 1] - (dims[0] if (l + 1) in cfg.skip_in else 0)
        if cfg.geometric_init:
            lins.append(init_linear_geometric(
                rng, dims[l], out_dim, l, num_layers, multires=cfg.multires,
                skip_layer=(l in cfg.skip_in), dims0=dims[0], bias=cfg.bias,
                inside_outside=cfg.inside_outside, weight_norm=cfg.weight_norm))
        else:
            lins.append(init_linear_default(rng, dims[l], out_dim,
                                            weight_norm=cfg.weight_norm))
    return lins


class ImplicitNet(nn.Module):
    def __init__(self, cfg: ImplicitNetConfig, rng: np.random.Generator):
        super().__init__()
        self.cfg = cfg
        self.spec = cfg.hash_spec()
        self.encoding = nn.Parameter(torch.from_numpy(
            he.init_hash_params(rng, self.spec)))
        self.lins = nn.ModuleList(WNLinear(p) for p in init_implicit_lins(rng, cfg))


def _mlp_forward(net: ImplicitNet, inp: torch.Tensor) -> torch.Tensor:
    """Softplus-β100 hidden layers, skip concats, optional fine clamp."""
    cfg = net.cfg
    h = inp
    n = len(net.lins)
    for l, lin in enumerate(net.lins):
        if l in cfg.skip_in:
            h = torch.cat([h, inp], dim=-1) / np.sqrt(2.0)
        h = lin(h)
        if l < n - 1:
            h = softplus_beta100(h)
    if cfg.clamp and cfg.name == "fine":
        h = torch.cat([torch.tanh(h[:, :1]) * 0.05, h[:, 1:]], dim=-1)
    return h


def _grid_features(net: ImplicitNet, x: torch.Tensor) -> torch.Tensor:
    if not net.cfg.use_grid_feature:
        return x.new_zeros((x.shape[0], net.cfg.grid_feature_dim))
    return he.hash_encode(net.spec, net.encoding,
                          (x / net.cfg.divide_factor).contiguous())


def _mlp_input(net: ImplicitNet, x: torch.Tensor, feats: torch.Tensor):
    if net.cfg.multires > 0:
        return torch.cat([positional_encoding(x, net.cfg.multires), feats], dim=-1)
    return torch.cat([x, feats], dim=-1)


def implicit_forward(net: ImplicitNet, x: torch.Tensor) -> torch.Tensor:
    """[N,3] -> [N, 1+feature_vector_size] (grid features through K2)."""
    return _mlp_forward(net, _mlp_input(net, x, _grid_features(net, x)))


def implicit_outputs_analytic(net: ImplicitNet, x: torch.Tensor):
    """(out [N,1+F], dSDF/dx [N,3]) via K1 + an MLP-only autograd.grad."""
    cfg = net.cfg
    if cfg.use_grid_feature:
        feats, dfeat = he.hash_encode_with_grad(
            net.spec, net.encoding, (x / cfg.divide_factor).contiguous())
        dfeat = dfeat / cfg.divide_factor
    else:
        feats, dfeat = x.new_zeros((x.shape[0], cfg.grid_feature_dim)), None
    inp = _mlp_input(net, x, feats)
    n_pe = inp.shape[-1] - feats.shape[-1]
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        if not inp.requires_grad:
            inp = inp.detach().requires_grad_(True)
        out = _mlp_forward(net, inp)
        (dsdf_dinp,) = torch.autograd.grad(out[:, 0].sum(), inp,
                                           create_graph=outer)
    if not outer:
        out = out.detach()
    grads = positional_encoding_grad_contract(x, cfg.multires, dsdf_dinp[:, :n_pe])
    if dfeat is not None:
        grads = grads + torch.einsum("nc,ncd->nd", dsdf_dinp[:, n_pe:], dfeat)
    return out, grads


# ---------------------------------------------------------------------------
# Coarse + fine combination (base_networks.py:7-47)
# ---------------------------------------------------------------------------

class CombineConfig(NamedTuple):
    coarse: ImplicitNetConfig
    fine: ImplicitNetConfig


def combine_config_from_conf(conf: Config, feature_vector_size: int) -> CombineConfig:
    return CombineConfig(
        coarse=implicit_config_from_conf(conf.get_config("coarse"),
                                         feature_vector_size, name="coarse"),
        fine=implicit_config_from_conf(conf.get_config("fine"),
                                       feature_vector_size, name="fine"))


class CombineNet(nn.Module):
    def __init__(self, cfg: CombineConfig, rng: np.random.Generator):
        super().__init__()
        self.cfg = cfg
        self.coarse = ImplicitNet(cfg.coarse, rng)
        self.fine = ImplicitNet(cfg.fine, rng)


def combine_forward(net: CombineNet, x: torch.Tensor, stage: str = "fine"):
    out_c = implicit_forward(net.coarse, x)
    if stage == "coarse":
        return out_c
    return out_c + implicit_forward(net.fine, x)


def combine_sdf(net: CombineNet, x: torch.Tensor, stage: str = "fine"):
    return combine_forward(net, x, stage)[:, :1]


def combine_get_outputs(net: CombineNet, x: torch.Tensor, stage: str = "fine"):
    """(sdf [N,1], features [N,F], gradients [N,3]), second-order ready."""
    out_c, g_c = implicit_outputs_analytic(net.coarse, x)
    if stage == "coarse":
        return out_c[:, :1], out_c[:, 1:], g_c
    out_f, g_f = implicit_outputs_analytic(net.fine, x)
    out = out_c + out_f
    return out[:, :1], out[:, 1:], g_c + g_f


def combine_gradient(net: CombineNet, x: torch.Tensor, stage: str = "fine"):
    return combine_get_outputs(net, x, stage)[2]


# ---------------------------------------------------------------------------
# bf16 inference path (K3) for the density-cache build and the exact
# prepass of an eval render; no gradient
# ---------------------------------------------------------------------------

def pack_combine_tables(net: CombineNet) -> Dict[str, torch.Tensor]:
    """Both SDF grids' tables as K3 reads them: [T, C] bfloat16."""
    return {"coarse": he.pack_table_bf16(net.coarse.encoding),
            "fine": he.pack_table_bf16(net.fine.encoding)}


def _implicit_sdf_packed(net: ImplicitNet, packed: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    if net.cfg.use_grid_feature:
        feats = he.hash_encode_bf16(net.spec, packed,
                                    (x / net.cfg.divide_factor).contiguous())
    else:
        feats = x.new_zeros((x.shape[0], net.cfg.grid_feature_dim))
    return _mlp_forward(net, _mlp_input(net, x, feats))[:, 0]


@torch.no_grad()
def combine_sdf_packed(net: CombineNet, packed: Dict[str, torch.Tensor],
                       x: torch.Tensor, stage: str = "fine") -> torch.Tensor:
    """SDF [N] with both grids read from ``pack_combine_tables`` (K3)."""
    s = _implicit_sdf_packed(net.coarse, packed["coarse"], x)
    if stage == "coarse":
        return s
    return s + _implicit_sdf_packed(net.fine, packed["fine"], x)


# ---------------------------------------------------------------------------
# Rendering (color) network, idr mode (base_networks.py:241-405)
# ---------------------------------------------------------------------------

class RenderingNetConfig(NamedTuple):
    mode: str = "idr"
    d_in: int = 9
    d_out: int = 3
    dims: Tuple[int, ...] = (64, 64)
    weight_norm: bool = True
    multires_view: int = 4
    use_grid_feature: bool = False
    feature_vector_size: int = 64
    color_num_levels: int = 16
    color_logmap: int = 24
    color_desired_res: int = 2048

    @property
    def grid_feature_dim(self) -> int:
        return (self.color_num_levels * 2) if self.use_grid_feature else 0

    def hash_spec(self) -> he.HashGridSpec:
        return he.make_spec(input_dim=3, num_levels=self.color_num_levels,
                            level_dim=2, per_level_scale=2.0, base_resolution=16,
                            log2_hashmap_size=self.color_logmap,
                            desired_resolution=self.color_desired_res)

    @property
    def layer_dims(self) -> Tuple[int, ...]:
        d0 = self.d_in + self.feature_vector_size + self.grid_feature_dim
        if self.multires_view > 0:
            d0 += positional_encoding_dim(self.multires_view, 3) - 3
        return (d0,) + tuple(self.dims) + (self.d_out,)


def rendering_config_from_conf(conf: Config, feature_vector_size: int) -> RenderingNetConfig:
    for opt in ("per_image_code", "model_exposure"):
        if conf.get_bool(opt, False):
            raise NotImplementedError(f"rendering_network.{opt} is not ported yet")
    mode = conf.get_string("mode", "idr")
    if mode != "idr":
        raise NotImplementedError(f"rendering mode {mode!r} is not ported yet")
    return RenderingNetConfig(
        mode=mode,
        d_in=conf.get_int("d_in", 9),
        d_out=conf.get_int("d_out", 3),
        dims=tuple(conf.get_list("dims", [64, 64])),
        weight_norm=conf.get_bool("weight_norm", True),
        multires_view=conf.get_int("multires_view", 0),
        use_grid_feature=conf.get_bool("use_grid_feature", False),
        feature_vector_size=feature_vector_size,
        color_num_levels=conf.get_int("color_num_levels", 16),
        color_logmap=conf.get_int("color_logmap", 24),
        color_desired_res=conf.get_int("color_desired_res", 2048),
    )


class RenderingNet(nn.Module):
    def __init__(self, cfg: RenderingNetConfig, rng: np.random.Generator):
        super().__init__()
        self.cfg = cfg
        self.spec = cfg.hash_spec() if cfg.use_grid_feature else None
        if cfg.use_grid_feature:
            self.encoding = nn.Parameter(torch.from_numpy(
                he.init_hash_params(rng, self.spec)))
        dims = cfg.layer_dims
        self.lins = nn.ModuleList(
            WNLinear(init_linear_default(rng, dims[l], dims[l + 1],
                                         weight_norm=cfg.weight_norm))
            for l in range(len(dims) - 1))


def rendering_forward(net: RenderingNet, points: torch.Tensor,
                      normals: torch.Tensor, view_dirs: torch.Tensor,
                      feature_vectors: torch.Tensor,
                      color_stage: str = "base") -> torch.Tensor:
    """Color per sample point [N,3] (idr mode). In the ``base`` color stage
    the color grid is detached: K2 runs forward only, under no_grad."""
    cfg = net.cfg
    parts = [points, positional_encoding(view_dirs, cfg.multires_view),
             normals, feature_vectors]
    if cfg.use_grid_feature:
        if color_stage == "base":
            with torch.no_grad():
                parts.append(he.hash_encode(net.spec, net.encoding, points))
        else:
            parts.append(he.hash_encode(net.spec, net.encoding, points))
    x = torch.cat(parts, dim=-1)
    for l, lin in enumerate(net.lins):
        x = lin(x)
        if l < len(net.lins) - 1:
            x = torch.relu(x)
    return torch.sigmoid(x)
