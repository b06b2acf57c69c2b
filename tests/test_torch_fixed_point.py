"""The K1/K2 table gradient in 64-bit fixed point, as the card computes it
at every C (csrc/hash_kernels.cuh hash_bwd_merge_kernel; a level of more
than 8 channels in segments, one exponent a level), against the JAX
package's table gradient on the CPU.

``hash_table_grad_fixed_plain`` is the kernel's arithmetic in torch: blocks
of 32 points, each corner's contribution rounded as the kernel rounds it,
the lanes that share a cell summed into the first (a run's head), each of
the head's corner sums rounded once to the level's fixed point and added
as an int64.
The card's kernel equals it bit for bit (chip_smoke.py phase 3). Here it
must equal the JAX package's ``hash_encode_with_grad`` / ``hash_encode``
table gradient within rtol 1e-5 and an atol of 1e-6 of the largest entry,
with a relative L2 below 1e-6: the two sum the same float32 terms in
other orders, a few ulps of entries up to ~50 (the Jacobian's cotangent
times dw/dx, up to 1.5 scale / (2 size)); a contribution lost or counted
twice by the merge is O(1e-2) off.

Points are ray-ordered (32 a ray, as the paths give a block: runs of lanes
in one cell, some rays leaving the cube) and
uniform, with cell fractions of exactly 0.5, where the smoothstep's
derivative peaks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu.ops import hash_encoder as jhe
from nicer_slam_tpu_torch.ops import hash_encoder as the
from nicer_slam_tpu_torch.slam.checkpoint import jax_layout, port_layout
from _torch_threads import one_torch_thread  # noqa: F401

SPECS = {
    # the coarse grid's shape: dense, 8 channels
    "dense_c8": dict(num_levels=2, level_dim=8, base_resolution=8,
                     log2_hashmap_size=19, desired_resolution=8),
    # the fine grid's: dense levels, then a hashed one (kernel res 17)
    "mixed_c4": dict(num_levels=3, level_dim=4, base_resolution=8,
                     log2_hashmap_size=12, desired_resolution=16),
    # the colour grid's: hashed levels whose corner products wrap uint32
    "hashed_c2": dict(num_levels=3, level_dim=2, base_resolution=16,
                      log2_hashmap_size=10, desired_resolution=64),
    # the channel counts of the segmented backward: one segment of C
    # channels (C 1, 3), three of 2 (C 6), three of 4 (C 12) and two of 8
    # (C 16); a dense level, then a hashed one
    "c1": dict(num_levels=2, level_dim=1, base_resolution=8,
               log2_hashmap_size=10, desired_resolution=16),
    "c3": dict(num_levels=2, level_dim=3, base_resolution=8,
               log2_hashmap_size=10, desired_resolution=16),
    "c6": dict(num_levels=2, level_dim=6, base_resolution=8,
               log2_hashmap_size=10, desired_resolution=16),
    "c12": dict(num_levels=2, level_dim=12, base_resolution=8,
                log2_hashmap_size=10, desired_resolution=16),
    "c16": dict(num_levels=3, level_dim=16, base_resolution=8,
                log2_hashmap_size=10, desired_resolution=16),
    # 40 levels (two launches of 20 on the card), small hashed tables
    "l40_c2": dict(num_levels=40, level_dim=2, base_resolution=4,
                   log2_hashmap_size=8, desired_resolution=64),
}
SIZE = 1.3


def _points(kind: str, spec, rng) -> np.ndarray:
    """ray-ordered: 8 rays x 32 samples sorted along each, from inside the
    cube, some leaving it; uniform: 256 points in [-1.05, 1.05]^3 x SIZE.
    The first 8 points of either sit at cell fractions of 0.5 on level 1."""
    if kind == "ray":
        o = rng.uniform(-0.6, 0.6, (8, 1, 3))
        d = rng.normal(size=(8, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = np.sort(rng.uniform(0.0, 1.6, (8, 32)), 1)[..., None]
        x = ((o + t * d) * SIZE).reshape(-1, 3)
    else:
        x = rng.uniform(-1.05, 1.05, (256, 3)) * SIZE
    cells = np.arange(24).reshape(8, 3) % 3 + 1.5
    x[:8] = cells / spec.scales[1] * 2.0 * SIZE - SIZE
    return x.astype(np.float32)


def _inputs(name, kind, seed=0):
    spec_j = jhe.make_spec(input_dim=3, **SPECS[name])
    spec_t = the.make_spec(input_dim=3, **SPECS[name])
    rng = np.random.default_rng(seed)
    x = _points(kind, spec_t, rng)
    L, C, n = spec_j.num_levels, spec_j.level_dim, x.shape[0]
    table = rng.uniform(-0.01, 0.01, (C, spec_j.total_entries)).astype(np.float32)
    g_feat = rng.standard_normal((n, L * C)).astype(np.float32)
    g_dfeat = rng.standard_normal((n, L * C, 3)).astype(np.float32)
    return spec_j, spec_t, table, x, g_feat, g_dfeat


def _jax_table_grad(spec_j, table, x, g_feat, g_dfeat, jac):
    if jac:
        _, vjp = jax.vjp(lambda e: jhe.hash_encode_with_grad(spec_j, e, jnp.asarray(x), SIZE),
                         jnp.asarray(table))
        (gt,) = vjp((jnp.asarray(g_feat), jnp.asarray(g_dfeat)))
    else:
        _, vjp = jax.vjp(lambda e: jhe.hash_encode(spec_j, e, jnp.asarray(x), SIZE),
                         jnp.asarray(table))
        (gt,) = vjp(jnp.asarray(g_feat))
    return np.asarray(gt)


# the shipped grids' shapes, then the segmented channel counts and a grid
# of more than 32 levels, K1 and K2 at each
@pytest.mark.parametrize("kind", ["ray", "uniform"])
@pytest.mark.parametrize("name,jac", [("dense_c8", True), ("mixed_c4", True),
                                      ("hashed_c2", False), ("mixed_c4", False)]
                         + [(name, jac) for name in ("c1", "c3", "c6", "c12", "c16", "l40_c2")
                            for jac in (True, False)])
def test_fixed_point_table_grad_matches_jax(name, jac, kind):
    spec_j, spec_t, table, x, g_feat, g_dfeat = _inputs(name, kind)
    got = the.hash_table_grad_fixed_plain(
        spec_t, torch.from_numpy(x), torch.from_numpy(g_feat),
        torch.from_numpy(g_dfeat) if jac else None, SIZE)
    want = _jax_table_grad(spec_j, table, x, g_feat, g_dfeat, jac)
    _close(jax_layout("encoding", got), want)
    # the points reach the table: not a vacuous comparison
    assert np.abs(want).max() > 0.1


def _close(got, want):
    scale = float(np.abs(want[np.isfinite(want)]).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
    ok = np.isfinite(want)
    assert np.linalg.norm(got[ok] - want[ok]) <= 1e-6 * np.linalg.norm(want[ok])


@pytest.mark.parametrize("name,jac", [("mixed_c4", True), ("hashed_c2", False)])
def test_fixed_point_table_grad_is_autograds_within_rounding(name, jac):
    """Against autograd of the port's plain encode on the same float32
    geometry (what chip_smoke.py holds the kernel to, within 1e-5): the
    merged float32 sums and one rounding to 2^-k per sum stay within
    float32's rounding, a relative L2 below 1e-6."""
    _, spec, table, x, g_feat, g_dfeat = _inputs(name, "ray", seed=1)
    tt = port_layout("encoding", table).requires_grad_(True)
    gf, gd = torch.from_numpy(g_feat), torch.from_numpy(g_dfeat)
    out = the.hash_encode_plain(spec, tt, torch.from_numpy(x), SIZE, jac)
    loss = (out[0] * gf).sum() + (out[1] * gd).sum() if jac else (out * gf).sum()
    (ref,) = torch.autograd.grad(loss, [tt])
    got = the.hash_table_grad_fixed_plain(spec, torch.from_numpy(x), gf, gd if jac else None,
                                          SIZE)
    assert float((got.double() - ref.double()).norm() / ref.double().norm()) < 1e-6


def test_fixed_point_nan_level_is_nan_in_every_row():
    """A non-finite cotangent at one level gives that level NaN in every
    row, touched or not (the JAX package's scatter gives NaN at the
    touched rows alone; ROADMAP.md lists the difference); the other levels
    are as without it."""
    spec_j, spec, table, x, g_feat, g_dfeat = _inputs("mixed_c4", "ray", seed=2)
    C = spec.level_dim
    bad = g_feat.copy()
    bad[5, 1 * C] = np.nan
    got = the.hash_table_grad_fixed_plain(spec, torch.from_numpy(x), torch.from_numpy(bad),
                                          torch.from_numpy(g_dfeat), SIZE)
    clean = the.hash_table_grad_fixed_plain(spec, torch.from_numpy(x),
                                            torch.from_numpy(g_feat),
                                            torch.from_numpy(g_dfeat), SIZE)
    r0, r1 = spec.offsets[1], spec.offsets[2]
    assert bool(got[r0:r1].isnan().all())
    assert torch.equal(got[:r0], clean[:r0]) and torch.equal(got[r1:], clean[r1:])
    want = _jax_table_grad(spec_j, table, x, bad, g_dfeat, True)
    jl = jax_layout("encoding", got)
    # the JAX package: NaN at the level's touched rows only, the rest as ours
    assert np.isnan(want[:, r0:r1]).any() and not np.isnan(want[:, r0:r1]).all()
    _close(jl[:, :r0], want[:, :r0])
    _close(jl[:, r1:], want[:, r1:])


def test_fixed_point_nan_in_one_segment_is_nan_in_every_column():
    """At C = 16 (two segments of 8 channels on the card) a NaN cotangent in
    one channel of the second segment makes every row and all 16 columns of
    its level NaN, since the level has one exponent; the other levels match
    the JAX package."""
    spec_j, spec, table, x, g_feat, g_dfeat = _inputs("c16", "ray", seed=3)
    C = spec.level_dim
    bad = g_feat.copy()
    bad[9, 1 * C + 12] = np.nan
    got = the.hash_table_grad_fixed_plain(spec, torch.from_numpy(x), torch.from_numpy(bad),
                                          torch.from_numpy(g_dfeat), SIZE)
    r0, r1 = spec.offsets[1], spec.offsets[2]
    assert got.shape[1] == 16 and bool(got[r0:r1].isnan().all())
    assert not bool(got[:r0].isnan().any()) and not bool(got[r1:].isnan().any())
    want = _jax_table_grad(spec_j, table, x, bad, g_dfeat, True)
    jl = jax_layout("encoding", got)
    _close(jl[:, :r0], want[:, :r0])
    _close(jl[:, r1:], want[:, r1:])


def test_fixed_point_scratch_holds_the_bitmap():
    """The kept state is the accumulator, the level maxima (32 words up to
    32 levels) and a bitmap of one bit a row; zero when allocated, and a
    word of any of the three counts."""
    spec = the.make_spec(input_dim=3, **SPECS["hashed_c2"])
    T, C = spec.total_entries, spec.level_dim
    s = the.fixed_point_scratch(spec, "cpu")
    assert s.dtype == torch.int64 and s.numel() == T * C + 32 + (T + 63) // 64
    assert the.fixed_point_state_is_zero(s)
    for at in (5, T * C + 3, s.numel() - 1):     # accumulator, maxima, bitmap
        s[at] = 7
        assert not the.fixed_point_state_is_zero(s)
        s[at] = 0
    assert the.fixed_point_state_is_zero(s)


def test_fixed_point_scratch_holds_every_levels_maxima():
    """Past 32 levels the maxima take L words (2 L uint32), so the grid's
    one maxima pass has a slot for every level."""
    spec = the.make_spec(input_dim=3, **SPECS["l40_c2"])
    T, C, L = spec.total_entries, spec.level_dim, spec.num_levels
    s = the.fixed_point_scratch(spec, "cpu")
    assert s.numel() == T * C + L + (T + 63) // 64 == the.fixed_point_words(spec)
    assert the.fixed_point_state_is_zero(s)
