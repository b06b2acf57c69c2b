"""A shrunk model configuration shared by the torch port's parity tests.

Every network keeps the demo configuration's structure (coarse grid with 8
channels, fine grid with dense and hashed levels, a color grid with a
hashed level, idr color MLP, PE 6/4) at CPU-sized widths and tables.
"""

from __future__ import annotations

MODEL_CONF = """
model {
    feature_vector_size = 8
    scene_bounding_sphere = 1.0
    use_warp_loss = true
    mapping_patchsizes = [ 1 ]
    density_method = "volsdf_gridpredefined"
    voxel_res = 16
    implicit_network {
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
        }
    }
    rendering_network {
        mode = "idr"  d_in = 9  d_out = 3  dims = [ 16 16 ]
        weight_norm = true  multires_view = 4  per_image_code = false
        use_grid_feature = true
        color_num_levels = 3  color_logmap = 10  color_desired_res = 64
    }
    ray_sampler {
        near = 0.0  N_samples = 12  N_samples_eval = 48  N_samples_extra = 6
        prepass_mode = cached  prepass_cache_res = 16
    }
}
"""

LOSS_CONF = """
loss {
    assign_scale_shift_init = true  assign_scale = 20.0
    warp_loss_weight = 0.5  warp_loss_type = "l1"
    eikonal_weight = 0.1  smooth_weight = 0.005  depth_weight = 0.1
    normal_l1_weight = 0.05  normal_cos_weight = 0.05  flow_weight = 0.001
    cam_freespace_w = 0.1
}
tracking_loss {
    eikonal_weight = 0  smooth_weight = 0  depth_weight = 0
    normal_l1_weight = 0  normal_cos_weight = 0
}
"""


def configs(H: int = 24, W: int = 32, n_images: int = 8):
    """(jax SceneConfig, torch SceneConfig, jax LossConfig pair, torch LossConfig pair)."""
    from nicer_slam_tpu import config
    from nicer_slam_tpu.models import losses as jl
    from nicer_slam_tpu.models import scene_model as jsm
    from nicer_slam_tpu_torch.models import losses as tl
    from nicer_slam_tpu_torch.models import scene_model as tsm

    c = config.parse_string(MODEL_CONF + LOSS_CONF)
    jcfg = jsm.scene_config_from_conf(c.get_config("model"), (H, W), n_images)
    tcfg = tsm.scene_config_from_conf(c.get_config("model"), (H, W), n_images)
    jloss = (jl.loss_config_from_conf(c.get_config("loss")),
             jl.loss_config_from_conf(c.get_config("tracking_loss")))
    tloss = (tl.loss_config_from_conf(c.get_config("loss")),
             tl.loss_config_from_conf(c.get_config("tracking_loss")))
    return jcfg, tcfg, jloss, tloss


def models(jcfg, tcfg, seed: int = 0):
    """The same weights in both packages (one numpy init stream)."""
    import numpy as np

    from nicer_slam_tpu.models import scene_model as jsm
    from nicer_slam_tpu_torch.models import scene_model as tsm

    return (jsm.init_scene_params(np.random.default_rng(seed), jcfg),
            tsm.SceneModel(tcfg, np.random.default_rng(seed)))
