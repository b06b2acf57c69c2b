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

The exact prepass in training splits its R rays into n = R // pc chunks of
pc = prepass_ray_chunk when R > pc and R % pc == 0 (scene_model.py:264-282):

                scene_model.py:271       keys = split(k_sample, n)
  per chunk c   ray_sampling.py:127      k_strat, k_extra, k_eik = split(keys[c], 3)
                                         (t_rand, perm, eik_idx of the chunk's pc rays)

so t_rand and eik_idx are the chunks' draws one after the other and perm
is [n, N_extra]. The cached prepass never chunks.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from nicer_slam_tpu_torch.models.scene_model import RenderDraws
from nicer_slam_tpu_torch.slam.mapping import MapDraws
from nicer_slam_tpu_torch.slam.tracking import TrackDraws


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.array(a)).to(dt)


def sampler_draws(k_sample, sampler_cfg, R: int):
    """(t_rand [R, Ne], perm [N_extra], eik_idx [R]) of one
    importance_z_vals call on R rays."""
    k_strat, k_extra, k_eik = jax.random.split(k_sample, 3)
    Ne = sampler_cfg.N_samples_eval
    S = sampler_cfg.N_samples + sampler_cfg.N_samples_extra + 2
    return (_t(jax.random.uniform(k_strat, (R, Ne))),
            _t(jax.random.permutation(k_extra, Ne)[: sampler_cfg.N_samples_extra],
               torch.int64),
            _t(jax.random.randint(k_eik, (R, 1), 0, S)[:, 0], torch.int64))


def render_draws(k_render, sampler_cfg, R: int, bound: float,
                 is_mapping: bool) -> RenderDraws:
    k_sample, k_uni, k_nei = jax.random.split(k_render, 3)
    pc = sampler_cfg.prepass_ray_chunk
    if sampler_cfg.prepass_mode != "cached" and pc and R > pc and R % pc == 0:
        chunks = [sampler_draws(k, sampler_cfg, pc)
                  for k in jax.random.split(k_sample, R // pc)]
        t_rand, perm, eik_idx = (torch.cat([c[0] for c in chunks]),
                                 torch.stack([c[1] for c in chunks]),
                                 torch.cat([c[2] for c in chunks]))
    else:
        t_rand, perm, eik_idx = sampler_draws(k_sample, sampler_cfg, R)
    if not is_mapping:
        return RenderDraws(t_rand, perm, eik_idx)
    eik_uniform = _t(jax.random.uniform(k_uni, (R * 10, 3), minval=-bound, maxval=bound))
    eik_nei = _t(jax.random.uniform(k_nei, (R * 11, 3)))
    return RenderDraws(t_rand, perm, eik_idx, eik_uniform, eik_nei)


def map_draws(key, scene_cfg, R: int) -> MapDraws:
    k_pix, k_render = jax.random.split(key)
    pix = torch.from_numpy(np.array(
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
        pix = torch.from_numpy(np.array(
            jax.random.randint(k_pix, (R,), 0, Hc * Wc))).to(torch.int64)
        out.append(TrackDraws(pix, render_draws(
            k_render, scene_cfg.sampler, R, scene_cfg.scene_bounding_sphere, False)))
    return out
