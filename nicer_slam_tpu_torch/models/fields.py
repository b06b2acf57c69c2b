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
the MLP twice; K1's own backward is first order. With
``concat_coarse_feature`` the fine MLP also reads the coarse network's
feature rows, so the fine network's cotangent on them is pulled back
through the coarse MLP as well (the JAX package's whole-network vjp,
``combine_get_outputs_vjp``, computed with the same analytic grid
Jacobians).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

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
    concat_coarse_feature: bool = False
    clamp: bool = False
    name: str = ""

    @property
    def grid_feature_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def layer_dims(self) -> Tuple[int, ...]:
        d0 = self.d_in + self.grid_feature_dim
        if self.concat_coarse_feature:
            d0 += self.feature_vector_size
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
        concat_coarse_feature=conf.get_bool("concat_coarse_feature", False),
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


def implicit_forward(net: ImplicitNet, x: torch.Tensor,
                     c_feature_vectors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N,3] -> [N, 1+feature_vector_size] (grid features through K2); the
    fine network with concat_coarse_feature also reads the coarse
    network's feature rows ``c_feature_vectors``."""
    feats = _grid_features(net, x)
    if net.cfg.concat_coarse_feature and c_feature_vectors is not None:
        feats = torch.cat([feats, c_feature_vectors], dim=-1)
    return _mlp_forward(net, _mlp_input(net, x, feats))


def _analytic_input(net: ImplicitNet, x: torch.Tensor,
                    c_feature_vectors: Optional[torch.Tensor] = None):
    """(MLP input, dfeat/dx of its grid columns or None, columns before
    the grid's): the grid features and their Jacobian from K1."""
    cfg = net.cfg
    if cfg.use_grid_feature:
        feats, dfeat = he.hash_encode_with_grad(
            net.spec, net.encoding, (x / cfg.divide_factor).contiguous())
        dfeat = dfeat / cfg.divide_factor
    else:
        feats, dfeat = x.new_zeros((x.shape[0], cfg.grid_feature_dim)), None
    n_pe = positional_encoding_dim(cfg.multires, 3) if cfg.multires > 0 else 3
    if cfg.concat_coarse_feature and c_feature_vectors is not None:
        feats = torch.cat([feats, c_feature_vectors], dim=-1)
    return _mlp_input(net, x, feats), dfeat, n_pe


def _contract(net: ImplicitNet, x: torch.Tensor, dsdf_dinp: torch.Tensor, dfeat, n_pe: int):
    """dSDF/dx [N,3] from dSDF/d(MLP input) through the positional
    encoding and the grid's Jacobian (the columns after the grid's, the
    coarse features, are the caller's)."""
    grads = positional_encoding_grad_contract(x, net.cfg.multires, dsdf_dinp[:, :n_pe])
    if dfeat is not None:
        n_grid = dfeat.shape[1]
        grads = grads + torch.einsum("nc,ncd->nd", dsdf_dinp[:, n_pe:n_pe + n_grid], dfeat)
    return grads


def implicit_outputs_analytic(net: ImplicitNet, x: torch.Tensor):
    """(out [N,1+F], dSDF/dx [N,3]) via K1 + an MLP-only autograd.grad."""
    inp, dfeat, n_pe = _analytic_input(net, x)
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        if not inp.requires_grad:
            inp = inp.detach().requires_grad_(True)
        out = _mlp_forward(net, inp)
        (dsdf_dinp,) = torch.autograd.grad(out[:, 0].sum(), inp,
                                           create_graph=outer)
    if not outer:
        out = out.detach()
    return out, _contract(net, x, dsdf_dinp, dfeat, n_pe)


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
    c_feat = out_c[:, 1:] if net.cfg.fine.concat_coarse_feature else None
    return out_c + implicit_forward(net.fine, x, c_feature_vectors=c_feat)


def combine_sdf(net: CombineNet, x: torch.Tensor, stage: str = "fine"):
    return combine_forward(net, x, stage)[:, :1]


def combine_get_outputs(net: CombineNet, x: torch.Tensor, stage: str = "fine"):
    """(sdf [N,1], features [N,F], gradients [N,3]), second-order ready."""
    if net.cfg.fine.concat_coarse_feature and stage != "coarse":
        return _combine_outputs_concat(net, x)
    out_c, g_c = implicit_outputs_analytic(net.coarse, x)
    if stage == "coarse":
        return out_c[:, :1], out_c[:, 1:], g_c
    out_f, g_f = implicit_outputs_analytic(net.fine, x)
    out = out_c + out_f
    return out[:, :1], out[:, 1:], g_c + g_f


def _combine_outputs_concat(net: CombineNet, x: torch.Tensor):
    """combine_get_outputs with concat_coarse_feature: the fine MLP reads
    the coarse output's feature rows, so dSDF/dx is the JAX package's
    whole-network vjp (``combine_get_outputs_vjp``): the fine network's
    cotangent on those rows, v, joins the coarse SDF's 1 as the coarse
    output's cotangent [1, v] pulled back through the coarse MLP. Both
    pullbacks are differentiable (create_graph), so the eikonal, smooth and
    normal terms differentiate them again."""
    outer = torch.is_grad_enabled()
    inp_c, dfeat_c, n_pe_c = _analytic_input(net.coarse, x)
    with torch.enable_grad():
        if not inp_c.requires_grad:
            inp_c = inp_c.detach().requires_grad_(True)
        out_c = _mlp_forward(net.coarse, inp_c)
        inp_f, dfeat_f, n_pe_f = _analytic_input(net.fine, x, out_c[:, 1:])
        out_f = _mlp_forward(net.fine, inp_f)
        (d_f,) = torch.autograd.grad(out_f[:, 0].sum(), inp_f, create_graph=outer)
        n_own = inp_f.shape[-1] - (out_c.shape[-1] - 1)
        cot = torch.cat([torch.ones_like(out_c[:, :1]), d_f[:, n_own:]], dim=-1)
        (d_c,) = torch.autograd.grad(out_c, inp_c, grad_outputs=cot, create_graph=outer)
    if not outer:
        out_c, out_f, d_f = out_c.detach(), out_f.detach(), d_f.detach()
    grads = (_contract(net.coarse, x, d_c, dfeat_c, n_pe_c)
             + _contract(net.fine, x, d_f[:, :n_own], dfeat_f, n_pe_f))
    out = out_c + out_f
    return out[:, :1], out[:, 1:], grads


def combine_gradient(net: CombineNet, x: torch.Tensor, stage: str = "fine"):
    return combine_get_outputs(net, x, stage)[2]


# ---------------------------------------------------------------------------
# bf16 inference path (K3) for the density-cache build and the exact
# prepass (the plain version of K6); no gradient
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
    """SDF [N] with both grids read from ``pack_combine_tables`` (K3).
    Not for concat_coarse_feature, whose prepass reads fp32 tables
    (``combine_sdf``), as in the JAX package."""
    if net.cfg.fine.concat_coarse_feature:
        raise ValueError("concat_coarse_feature: the packed bf16 SDF does not take the "
                         "coarse features (the JAX package's combine_sdf_packed fails there "
                         "with a shape error); its prepass reads combine_sdf")
    s = _implicit_sdf_packed(net.coarse, packed["coarse"], x)
    if stage == "coarse":
        return s
    return s + _implicit_sdf_packed(net.fine, packed["fine"], x)


# ---------------------------------------------------------------------------
# Rendering (color) network (base_networks.py:241-405)
# ---------------------------------------------------------------------------

# the MLP input of each mode, in order ("grid" only where the color grid is
# on); "no_color" runs no MLP: sigmoid of the first 3 feature channels
RENDER_MODES = {
    "idr": ("points", "view_dirs", "normals", "features", "grid"),
    "idr_detach": ("points", "view_dirs", "normals_detached", "features"),
    "idr_nopts": ("view_dirs", "normals", "features"),
    "idr_nopts_detach": ("view_dirs", "normals_detached", "features"),
    "idr_nonormal": ("points", "view_dirs", "features"),
    "idr_noview": ("points", "normals", "features"),
    "nerf": ("view_dirs", "features"),
    "no_feature": ("points", "view_dirs", "normals"),
    "no_feature_no_noraml": ("points", "view_dirs"),
    "no_color": (),
}
# width of a per-image code (per_image_code) and of an exposure code
# (model_exposure)
IMAGE_CODE_DIM = 32
EXPOSURE_CODE_DIM = 4


class RenderingNetConfig(NamedTuple):
    mode: str = "idr"
    d_in: int = 9
    d_out: int = 3
    dims: Tuple[int, ...] = (64, 64)
    weight_norm: bool = True
    multires_view: int = 4
    per_image_code: bool = False
    model_exposure: bool = False
    n_images: int = 2000
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
        fvs = self.feature_vector_size
        if self.mode in ("no_feature", "no_feature_no_noraml"):
            fvs = 0
        d0 = self.d_in + fvs + self.grid_feature_dim
        if self.multires_view > 0:
            d0 += positional_encoding_dim(self.multires_view, 3) - 3
        if self.per_image_code:
            d0 += IMAGE_CODE_DIM
        return (d0,) + tuple(self.dims) + (self.d_out,)


def check_rendering_config(cfg: RenderingNetConfig) -> None:
    """Raise ValueError for a mode the JAX package does not know and for the
    combinations it cannot run (each fails there with a shape error):
    a mode whose MLP input leaves out the color grid that ``layer_dims``
    counts, ``per_image_code`` with ``model_exposure`` (the exposure codes
    replace the per-image codes the first layer is sized for), and
    ``no_color`` with ``model_exposure`` (no second colour to return)."""
    if cfg.mode not in RENDER_MODES:
        raise ValueError(f"unknown rendering mode {cfg.mode!r}; one of {sorted(RENDER_MODES)}")
    if cfg.use_grid_feature and cfg.mode not in ("idr", "no_color"):
        raise ValueError(f"rendering mode {cfg.mode!r} with use_grid_feature: the mode's "
                         f"input leaves out the color grid that the first layer counts")
    if cfg.per_image_code and cfg.model_exposure:
        raise ValueError("per_image_code with model_exposure: both keep per-image "
                         "embeddings, and the exposure codes replace the per-image codes")
    if cfg.mode == "no_color" and cfg.model_exposure:
        raise ValueError("rendering mode 'no_color' with model_exposure: no_color "
                         "returns one colour, exposure needs two")


def rendering_config_from_conf(conf: Config, feature_vector_size: int,
                               n_images: int = 2000) -> RenderingNetConfig:
    cfg = RenderingNetConfig(
        mode=conf.get_string("mode", "idr"),
        d_in=conf.get_int("d_in", 9),
        d_out=conf.get_int("d_out", 3),
        dims=tuple(conf.get_list("dims", [64, 64])),
        weight_norm=conf.get_bool("weight_norm", True),
        multires_view=conf.get_int("multires_view", 0),
        per_image_code=conf.get_bool("per_image_code", False),
        model_exposure=conf.get_bool("model_exposure", False),
        n_images=n_images,
        use_grid_feature=conf.get_bool("use_grid_feature", False),
        feature_vector_size=feature_vector_size,
        color_num_levels=conf.get_int("color_num_levels", 16),
        color_logmap=conf.get_int("color_logmap", 24),
        color_desired_res=conf.get_int("color_desired_res", 2048),
    )
    check_rendering_config(cfg)
    return cfg


class RenderingNet(nn.Module):
    """The color MLP (``lins``), the color grid (``encoding``) where it is
    on, the per-image codes (``embeddings``: [n_images, 32] with
    per_image_code, [n_images, 4] with model_exposure) and the exposure MLP
    (``exp_lins``, 4 -> 64 -> 64 -> 6, no weight norm), drawn from ``rng``
    in the JAX package's order."""

    def __init__(self, cfg: RenderingNetConfig, rng: np.random.Generator):
        super().__init__()
        check_rendering_config(cfg)
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
        code_dim = (IMAGE_CODE_DIM if cfg.per_image_code
                    else EXPOSURE_CODE_DIM if cfg.model_exposure else 0)
        if code_dim:
            self.embeddings = nn.Parameter(torch.from_numpy(
                rng.uniform(-1e-4, 1e-4, (cfg.n_images, code_dim)).astype(np.float32)))
        if cfg.model_exposure:
            self.exp_lins = nn.ModuleList(
                WNLinear(init_linear_default(rng, a, b, weight_norm=False))
                for a, b in ((EXPOSURE_CODE_DIM, 64), (64, 64), (64, 6)))


def _from_euler(angles: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [N, 3, 3] from Euler angles [N, 3] (the JAX
    package's ``_from_euler_jax``)."""
    sx, sy, sz = torch.sin(angles).unbind(-1)
    cx, cy, cz = torch.cos(angles).unbind(-1)
    row0 = torch.stack([cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz], -1)
    row1 = torch.stack([cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz], -1)
    row2 = torch.stack([-sy, sx * cy, cx * cy], -1)
    return torch.stack([row0, row1, row2], -2)


def rendering_forward(net: RenderingNet, points: torch.Tensor,
                      normals: torch.Tensor, view_dirs: torch.Tensor,
                      feature_vectors: torch.Tensor, color_stage: str = "base",
                      image_indices: Optional[torch.Tensor] = None):
    """Color per sample point [N,3] in the configured mode
    (base_networks.py:333-395). In the ``base`` color stage the color grid
    is detached: K2 runs forward only, under no_grad. A render net whose
    ``color_shard`` is set holds only its rank's rows of the color grid and
    encodes through ``hash_encode_sharded`` (an all-gather forward, a
    reduce-scatter in the backward of the ``highfreq`` stage). ``image_indices``
    [N] (each point's frame index) selects the per-image or exposure codes.
    With ``model_exposure`` the result is (sigmoid(R·x + t), sigmoid(x)):
    the exposure-corrected colour and the colour before it."""
    cfg = net.cfg
    if cfg.mode == "no_color":
        return torch.sigmoid(feature_vectors[:, :3])
    inputs = {"points": points, "normals": normals, "features": feature_vectors,
              "view_dirs": positional_encoding(view_dirs, cfg.multires_view)}
    if "normals_detached" in RENDER_MODES[cfg.mode]:
        inputs["normals_detached"] = normals.detach()
    if cfg.use_grid_feature:
        shard = getattr(net, "color_shard", None)
        if shard is None:
            encode = lambda: he.hash_encode(net.spec, net.encoding, points)
        else:
            # the table is this rank's rows (parallel/mesh.shard_color_grid)
            encode = lambda: he.hash_encode_sharded(net.spec, net.encoding, points, shard)
        if color_stage == "base":
            with torch.no_grad():
                inputs["grid"] = encode()
        else:
            inputs["grid"] = encode()
    x = torch.cat([inputs[k] for k in RENDER_MODES[cfg.mode] if k in inputs], dim=-1)
    if cfg.per_image_code:
        x = torch.cat([x, net.embeddings[image_indices]], dim=-1)
    for l, lin in enumerate(net.lins):
        x = lin(x)
        if l < len(net.lins) - 1:
            x = torch.relu(x)
    if not cfg.model_exposure:
        return torch.sigmoid(x)
    h = net.embeddings[image_indices]
    for i, lin in enumerate(net.exp_lins):
        h = lin(h)
        if i < len(net.exp_lins) - 1:
            h = torch.relu(h)
    x_nor = torch.einsum("nij,nj->ni", _from_euler(h[..., :3]), x) + h[..., 3:]
    return torch.sigmoid(x_nor), torch.sigmoid(x)
