"""Parity of the torch port's hash encoder (K1 hash_encode_with_grad, K2
hash_encode) with the JAX package's, on the CPU (the port's plain versions;
the CUDA kernels are held against those on the card by chip_smoke.py).

Tables are drawn in the JAX package's ``[C, T]`` layout and reach the port
as its ``[T, C]`` through the checkpoint boundary's ``port_layout``; the
port's table gradients come back through ``jax_layout``.

Tolerances: values atol 1e-6 and gradients rtol 1e-5 / atol 1e-6, float32
throughout — the two packages sum the same float32 terms in different
orders. Tables are U(-0.01, 0.01), so features are O(1e-2) and Jacobians
O(1): an index or weight mistake is many orders above the tolerance.
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
    # fractional per-level scale (allocator vs kernel resolution), all dense
    "dense_c4": dict(num_levels=3, level_dim=4, base_resolution=8,
                     log2_hashmap_size=13, desired_resolution=16),
    # the same with a smaller table: the last level (kernel res 17) hashes
    "mixed_c4": dict(num_levels=3, level_dim=4, base_resolution=8,
                     log2_hashmap_size=12, desired_resolution=16),
    # coarse-grid shape: dense, 8 channels
    "dense_c8": dict(num_levels=2, level_dim=8, base_resolution=8,
                     log2_hashmap_size=19, desired_resolution=8),
    # every level hashed into 2^10 rows; corner coords up to 64, so the
    # products with 2654435761 and 805459861 overflow 32 bits (uint32 wrap)
    "hashed_c2": dict(num_levels=3, level_dim=2, base_resolution=16,
                      log2_hashmap_size=10, desired_resolution=64),
    # a dense level and a 2^21-row hashed level: the JAX hash_encode takes
    # its big-grid sorted-backward path here (the color grid's)
    "big_c2": dict(num_levels=2, level_dim=2, base_resolution=48,
                   log2_hashmap_size=21, desired_resolution=160),
    # channel counts no shipped grid has (K1/K2 take 1 to 8): odd, and even
    # but not a multiple of 4
    "hashed_c3": dict(num_levels=3, level_dim=3, base_resolution=16,
                      log2_hashmap_size=10, desired_resolution=64),
    "mixed_c6": dict(num_levels=3, level_dim=6, base_resolution=8,
                     log2_hashmap_size=12, desired_resolution=16),
}


def _inputs(name, n=257, seed=0):
    spec_j = jhe.make_spec(input_dim=3, **SPECS[name])
    spec_t = the.make_spec(input_dim=3, **SPECS[name])
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.01, 0.01, (spec_j.level_dim, spec_j.total_entries)
                        ).astype(np.float32)
    x = rng.uniform(-1.05, 1.05, (n, 3)).astype(np.float32)
    C, L = spec_j.level_dim, spec_j.num_levels
    g_feat = rng.standard_normal((n, L * C)).astype(np.float32)
    g_dfeat = rng.standard_normal((n, L * C, 3)).astype(np.float32)
    return spec_j, spec_t, table, x, g_feat, g_dfeat


def _port(table):
    """A JAX-layout [C, T] table as the port holds it, [T, C]."""
    return port_layout("encoding", table)


def test_make_spec_matches():
    for kw in SPECS.values():
        assert tuple(jhe.make_spec(**kw)) == tuple(the.make_spec(**kw))
    # the demo configuration's three grids
    for kw in (dict(num_levels=4, level_dim=8, base_resolution=32,
                    log2_hashmap_size=19, desired_resolution=32),
               dict(num_levels=8, level_dim=4, base_resolution=32,
                    log2_hashmap_size=19, desired_resolution=128),
               dict(num_levels=16, level_dim=2, base_resolution=16,
                    log2_hashmap_size=24, desired_resolution=2048)):
        assert tuple(jhe.make_spec(**kw)) == tuple(the.make_spec(**kw))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_hash_encode_matches_jax(name):
    spec_j, spec_t, table, x, g_feat, _ = _inputs(name)
    f_j, vjp = jax.vjp(lambda e, xx: jhe.hash_encode(spec_j, e, xx),
                       jnp.asarray(table), jnp.asarray(x))
    gt_j, gx_j = vjp(jnp.asarray(g_feat))

    tt = _port(table).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    f_t = the.hash_encode(spec_t, tt, xt)
    gt_t, gx_t = torch.autograd.grad(f_t, [tt, xt], torch.from_numpy(g_feat))

    np.testing.assert_allclose(f_t.detach().numpy(), np.asarray(f_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(jax_layout("encoding", gt_t), np.asarray(gt_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), rtol=1e-5, atol=1e-6)
    # points outside [-1, 1]^3 give zero features
    oob = (np.abs(x) > 1).any(-1)
    assert oob.any() and np.all(f_t.detach().numpy()[oob] == 0)


@pytest.mark.parametrize("name", ["dense_c4", "mixed_c4", "dense_c8", "hashed_c2",
                                  "hashed_c3", "mixed_c6"])
def test_hash_encode_with_grad_matches_jax(name):
    spec_j, spec_t, table, x, g_feat, g_dfeat = _inputs(name)
    (f_j, d_j), vjp = jax.vjp(lambda e, xx: jhe.hash_encode_with_grad(spec_j, e, xx),
                              jnp.asarray(table), jnp.asarray(x))
    gt_j, gx_j = vjp((jnp.asarray(g_feat), jnp.asarray(g_dfeat)))

    tt = _port(table).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    f_t, d_t = the.hash_encode_with_grad(spec_t, tt, xt)
    gt_t, gx_t = torch.autograd.grad([f_t, d_t], [tt, xt],
                                     [torch.from_numpy(g_feat), torch.from_numpy(g_dfeat)])

    np.testing.assert_allclose(f_t.detach().numpy(), np.asarray(f_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(d_t.detach().numpy(), np.asarray(d_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(jax_layout("encoding", gt_t), np.asarray(gt_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), rtol=1e-5, atol=1e-6)


def test_dfeat_is_the_jacobian_of_feats():
    """dfeat/dx of K1's plain version equals autograd's Jacobian of feats
    (float64, so the check is tight)."""
    spec = the.make_spec(**SPECS["hashed_c2"])
    _, _, table, x, _, _ = _inputs("hashed_c2", n=9)
    t64 = _port(table).double()
    x64 = torch.from_numpy(x).double() * 0.9
    _, dfeat = the.hash_encode_with_grad(spec, t64, x64)
    jac = torch.autograd.functional.jacobian(
        lambda xx: the.hash_encode(spec, t64, xx), x64)          # [N,F,N,3]
    jac = torch.einsum("nfnd->nfd", jac)
    torch.testing.assert_close(dfeat, jac, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["dense_c4", "dense_c8"])
def test_hash_encode_matches_dense_reference(name):
    spec_j, spec_t, table, x, _, _ = _inputs(name)
    ref = jhe.hash_encode_dense_ref(spec_j, table, x)
    out = the.hash_encode(spec_t, _port(table), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


def test_hash_index_uint32_wrap():
    """int64 index math masked to 32 bits equals the reference's uint32
    arithmetic, including negative (out-of-range) corners."""
    spec = the.make_spec(**SPECS["hashed_c2"])
    rng = np.random.default_rng(3)
    corner = rng.integers(-3, 70, (8, 50, 3)).astype(np.int64)
    got = the._level_rows(spec, 2, torch.from_numpy(corner)).numpy()
    c = corner.astype(np.int32).astype(np.uint32)
    want = (c[..., 0] * np.uint32(1)) ^ (c[..., 1] * np.uint32(2654435761)) \
        ^ (c[..., 2] * np.uint32(805459861))
    size = spec.offsets[3] - spec.offsets[2]
    np.testing.assert_array_equal(got, want % np.uint32(size) + spec.offsets[2])


@pytest.mark.parametrize("L,C,bf16,ok", [
    (32, 8, False, True), (16, 1, False, True), (8, 3, False, True), (4, 7, False, True),
    (2, 9, False, True), (33, 2, False, True), (8, 6, True, True), (8, 4, True, True),
    (8, 3, True, False), (4, 1, True, False)])
def test_kernel_spec_limits(L, C, bf16, ok):
    """K1/K2 take any level and channel count (a level's channels walked in
    segments of at most 8, more than 32 (level, segment) pairs in several
    launches); K3 takes any even C, as the JAX package's packed encode."""
    spec = the.make_spec(input_dim=3, num_levels=L, level_dim=C, base_resolution=8,
                         log2_hashmap_size=10, desired_resolution=64)
    if ok:
        the._check_spec(spec, bf16=bf16)
    else:
        with pytest.raises(ValueError, match="kernel supports"):
            the._check_spec(spec, bf16=bf16)


def test_cuda_wrapper_rejects_other_devices():
    spec = the.make_spec(**SPECS["dense_c4"])
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        the.hash_encode(spec, torch.zeros((spec.total_entries, 4), device="meta"), x)


@pytest.mark.parametrize("name", ["mixed_c4", "hashed_c2", "dense_c8"])
def test_fixed_point_bound_covers_every_contribution(name):
    """The kernels' backward sums the table gradient in 64-bit fixed point
    with a per-level exponent taken from a bound on any one contribution
    (csrc/hash_encoder.cu): max|g_feat| + 1.5 scale_l / (2 size) times the
    largest sum_d |g_dfeat[., d]| of the level. One point's table gradient
    (plain version, autograd) is its 8 corner contributions; a row holds
    as many of them as the point has corners there, and none may exceed
    the bound. Points include cell fractions of exactly 0.5, where the
    smoothstep's derivative 6 f (1 - f) peaks at 1.5."""
    spec = the.make_spec(**SPECS[name])
    _, _, table, x, g_feat, g_dfeat = _inputs(name, n=40, seed=5)
    size, L, C = 1.3, spec.num_levels, spec.level_dim
    # the centres of 8 cells of level 1: a fraction of 0.5 on every axis
    cells = np.arange(24).reshape(8, 3) % 3 + 1.5
    x[:8] = (cells / spec.scales[1] * 2.0 * size - size).astype(np.float32)
    t = _port(table).clone().requires_grad_(True)
    gf = torch.from_numpy(g_feat).reshape(-1, L, C)
    gd = torch.from_numpy(g_dfeat).reshape(-1, L, C, 3)
    bound = [float(gf[:, lvl].abs().max())
             + 1.5 * spec.scales[lvl] / (2.0 * size)
             * float(gd[:, lvl].abs().sum(-1).max()) for lvl in range(L)]
    bits = torch.tensor([[(k >> d) & 1 for d in range(3)] for k in range(8)])
    peak = 0.0
    for n in range(x.shape[0]):
        xn = torch.from_numpy(x[n:n + 1])
        feats, dfeat = the.hash_encode_plain(spec, t, xn, size, jacobian=True)
        (g,) = torch.autograd.grad((feats * torch.from_numpy(g_feat[n:n + 1])).sum()
                                   + (dfeat * torch.from_numpy(g_dfeat[n:n + 1])).sum(), t)
        u = (xn.double() + size) / (2.0 * size)
        if ((u < 0) | (u > 1)).any():
            assert not g.any()
            continue
        for lvl in range(L):
            corner = torch.floor(u * spec.scales[lvl]).long()[None] + bits[:, None, :]
            rows = the._level_rows(spec, lvl, corner)[:, 0]
            uniq, counts = torch.unique(rows, return_counts=True)
            per_row = g[uniq].abs().amax(dim=1) / counts
            assert float(per_row.max()) <= bound[lvl] * (1 + 1e-6), (n, lvl)
            peak = max(peak, float(per_row.max()) / bound[lvl])
    # the bound is reached within a factor of a few, not loose by orders
    assert peak > 0.05
