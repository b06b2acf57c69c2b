"""concat_coarse_feature in the torch port's mapping step, on the CPU: one
exact-prepass map_step with BA of the shrunk model with the fine network
reading the coarse network's feature rows, against the JAX package's, to
the tolerances of tests/test_torch_slice.py (whose case this reuses: loss
terms, parameter updates, poses, the voxel counter). The exact prepass
runs the concat variant's plain version (fp32 ``combine_sdf``, as the JAX
package's prepass there) and the training pass ``combine_get_outputs``'s
pullback through the coarse features; the β scale keeps every ray clear of
the u = 1 tie and the monocular depth term is off, as in
tests/test_torch_options_slam.py's exact map_step (same reasons).
"""

import jax
import jax.numpy as jnp  # noqa: F401
import numpy as np  # noqa: F401
import pytest
import torch

from nicer_slam_tpu import config as jconfig
from nicer_slam_tpu.models import scene_model as jsm
from nicer_slam_tpu_torch.models import scene_model as tsm

from test_torch_options import BETA_SCALE, N_IMAGES, RAY_CHUNK, concat_text
from test_torch_slice import H, W, _map_step_case, scene  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401



def test_concat_map_step_matches_jax(scene):  # noqa: F811
    text = concat_text().replace("prepass_mode = exact", f"prepass_ray_chunk = {RAY_CHUNK}")
    c = jconfig.parse_string(text).get_config("model")
    cfgs = (jsm.scene_config_from_conf(c, (H, W), N_IMAGES),
            tsm.scene_config_from_conf(c, (H, W), N_IMAGES))
    assert cfgs[1].combine.fine.concat_coarse_feature
    assert cfgs[1].sampler.prepass_mode == "exact"
    _map_step_case(scene, color_topk=0, cfgs=cfgs, loss_edits=dict(depth_weight=0.0),
                   beta_scale=BETA_SCALE)
