"""Replays the JAX package's random draws for the torch port's parity tests.

JAX's PRNG and torch's give different numbers from one seed, so every draw
the port takes as an argument is made here with the JAX package's own key
splits and handed to the port as a tensor:

  map_step      mapping.py:138-140       k_pix, k_render = split(key)
                                         pix = randint(k_pix, (R,), 0, HW)
  track_frame   tracking.py:107-110      k = fold_in(key, it)
                                         k_pix, k_render = split(k)
                                         pix = randint(k_pix, (R,), 0, Hc*Wc)
  render_rays   scene_model.py:226       k_sample, k_uni, k_nei = split(k_render, 3)
                scene_model.py:473-479   eik_uniform = uniform(k_uni, (10R,3), -b, b)
                                         eik_nei = uniform(k_nei, (11R,3))
  sampler       ray_sampling.py:127      k_strat, k_extra, k_eik = split(k_sample, 3)
                ray_sampling.py:81       t_rand = uniform(k_strat, (R, Ne))
                ray_sampling.py:151      perm = permutation(k_extra, Ne)[:N_extra]
                ray_sampling.py:161      eik_idx = randint(k_eik, (R,1), 0, S)

(the cached prepass never chunks its rays, so no per-chunk key split).
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from nicer_slam_tpu_torch.models.scene_model import RenderDraws
from nicer_slam_tpu_torch.slam.mapping import MapDraws
from nicer_slam_tpu_torch.slam.tracking import TrackDraws


def render_draws(k_render, sampler_cfg, R: int, bound: float,
                 is_mapping: bool) -> RenderDraws:
    k_sample, k_uni, k_nei = jax.random.split(k_render, 3)
    k_strat, k_extra, k_eik = jax.random.split(k_sample, 3)
    Ne = sampler_cfg.N_samples_eval
    S = sampler_cfg.N_samples + sampler_cfg.N_samples_extra + 2
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dt)
    t_rand = t(jax.random.uniform(k_strat, (R, Ne)))
    perm = t(jax.random.permutation(k_extra, Ne)[: sampler_cfg.N_samples_extra],
             torch.int64)
    eik_idx = t(jax.random.randint(k_eik, (R, 1), 0, S)[:, 0], torch.int64)
    if not is_mapping:
        return RenderDraws(t_rand, perm, eik_idx)
    eik_uniform = t(jax.random.uniform(k_uni, (R * 10, 3), minval=-bound,
                                       maxval=bound))
    eik_nei = t(jax.random.uniform(k_nei, (R * 11, 3)))
    return RenderDraws(t_rand, perm, eik_idx, eik_uniform, eik_nei)


def map_draws(key, scene_cfg, R: int) -> MapDraws:
    k_pix, k_render = jax.random.split(key)
    pix = torch.from_numpy(np.asarray(
        jax.random.randint(k_pix, (R,), 0, scene_cfg.H * scene_cfg.W))).to(torch.int64)
    return MapDraws(pix, render_draws(k_render, scene_cfg.sampler, R,
                                      scene_cfg.scene_bounding_sphere, True))


def track_draws(key, scene_cfg, track_cfg):
    R = track_cfg.num_pixels
    Hc = scene_cfg.H - 2 * track_cfg.Hedge
    Wc = scene_cfg.W - 2 * track_cfg.Wedge
    out = []
    for it in range(track_cfg.num_iters):
        k_pix, k_render = jax.random.split(jax.random.fold_in(key, it))
        pix = torch.from_numpy(np.asarray(
            jax.random.randint(k_pix, (R,), 0, Hc * Wc))).to(torch.int64)
        out.append(TrackDraws(pix, render_draws(
            k_render, scene_cfg.sampler, R, scene_cfg.scene_bounding_sphere, False)))
    return out
