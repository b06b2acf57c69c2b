"""K4's colour top-k path of the torch port on the CPU: the weights pass's
backward in closed form against autograd and against the JAX package, and
numpy emulations of what csrc/composite.cu does in a warp (the 64-bit pick
keys, the radix select, the interleaved sample layout), so that the kernel's logic is checked where no card is.
chip_smoke.py holds the kernels themselves against these plain versions on
the card.

Tolerances: float32 gradients atol 1e-5 and rtol 1e-5 (the packages and
the closed form sum in other orders); picks and index maps exact.

XLA:CPU flushes subnormal floats to zero and torch on the CPU (like the
kernel on the card) keeps them, so a weight past an opaque sample can be
3.9e-40 in the port and 0 in the JAX package, and the two then pick other
samples among the ray's smallest weights. The comparisons with the JAX
package therefore run with torch's CPU flushing subnormals too
(``flush_denormal``); the order of subnormal weights is held by the key
emulations below, and on the card by chip_smoke.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nicer_slam_tpu.ops import volume_rendering as jvr
from nicer_slam_tpu_torch.ops import volume_rendering as tvr
from _torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy


def _weights_pass_jax(z, density, normals, Kc):
    """render_weights + lax.top_k of the JAX package (scene_model.py:321-357,
    489-491): (weights, depth, normal, topk_w, wsum), top-k indices."""
    w = jvr.render_weights(z, density)
    topk_w, topk_i = jax.lax.top_k(w, Kc)
    wsum = w.sum(1, keepdims=True)
    depth = (w * z).sum(1, keepdims=True) / (wsum + 1e-8)
    return (w, depth, (w[..., None] * normals).sum(1), topk_w, wsum), topk_i


@contextlib.contextmanager
def flush_denormal():
    """torch's CPU flushes subnormals to zero inside, as XLA:CPU does."""
    assert torch.set_flush_denormal(True), "this CPU cannot flush subnormals"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _case(name):
    """(z, density, normals, Kc) of one case, from a seed."""
    rng = np.random.default_rng({"zero_ties": 1, "sparse": 2, "flagship": 3}[name])
    if name == "flagship":
        R, S, Kc = 12, 98, 16
    else:
        R, S, Kc = 16, 30, 8
    z = np.sort(rng.uniform(0.1, 3.0, (R, S)), 1).astype(np.float32)
    dens = rng.uniform(0, 8, (R, S)).astype(np.float32)
    if name == "zero_ties":
        # empty space up to sample 4 (weights exactly 0 with T = 1), then an
        # opaque sample (every later weight exactly 0 with T = 0)
        dens[:, :4] = 0.0
        dens[:, 5] = 1e4
    elif name == "sparse":
        # the Laplace density of an SDF crossing zero at a random depth, β
        # 3e-3: fewer than Kc weights are non-zero on most rays
        surf = rng.uniform(0.5, 2.5, (R, 1)).astype(np.float32)
        sdf = surf - z
        beta = np.float32(3e-3)
        dens = ((0.5 + 0.5 * np.sign(sdf) * np.expm1(-np.abs(sdf) / beta)) / beta
                ).astype(np.float32)
    nrm = rng.standard_normal((R, S, 3)).astype(np.float32)
    return z, dens, nrm, Kc


@pytest.mark.parametrize("name", ["zero_ties", "sparse", "flagship"])
def test_weights_topk_bwd_closed_form_matches_autograd_and_jax(name):
    """weights_topk_bwd_plain (the formula the kernel computes) equals
    autograd through weights_topk_plain and JAX's vjp, with cotangents on
    all five outputs; the picks equal lax.top_k's."""
    z, dens, nrm, Kc = _case(name)
    R, S = z.shape
    rng = np.random.default_rng(7)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((R, S), (R, 1), (R, 3), (R, Kc), (R, 1))]
    if name == "sparse":
        nonzero = (np.asarray(jvr.render_weights(jnp.asarray(z), jnp.asarray(dens))) > 0)
        assert (nonzero.sum(1) < Kc).mean() > 0.5

    def f_j(d, n):
        return _weights_pass_jax(jnp.asarray(z), d, n, Kc)[0]

    _, vjp = jax.vjp(f_j, jnp.asarray(dens), jnp.asarray(nrm))
    g_j = vjp(tuple(jnp.asarray(c) for c in cots))
    idx_j = np.asarray(_weights_pass_jax(jnp.asarray(z), jnp.asarray(dens),
                                         jnp.asarray(nrm), Kc)[1])

    with flush_denormal():
        ins = [T(dens).requires_grad_(True), T(nrm).requires_grad_(True)]
        outs = tvr.weights_topk_plain(T(z), *ins, Kc)
        g_auto = torch.autograd.grad(outs[:5], ins, [T(c) for c in cots])
        picks = outs[5]
        g_w, g_d, g_n, g_tw, g_ws = map(T, cots)
        g_closed = tvr.weights_topk_bwd_plain(T(z), T(dens), T(nrm), picks, g_w, g_d, g_n,
                                              g_tw, g_ws)
    np.testing.assert_array_equal((picks - torch.arange(R)[:, None] * S).numpy(), idx_j)
    for closed, auto, jx in zip(g_closed, g_auto, g_j):
        np.testing.assert_allclose(closed.numpy(), auto.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(closed.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)


def test_weights_topk_bwd_closed_form_takes_missing_cotangents():
    """A cotangent that does not reach the weights pass is None (the path's
    g_weights is None: nothing reads the weights with a gradient)."""
    z, dens, nrm, Kc = _case("flagship")
    R, S = z.shape
    rng = np.random.default_rng(8)
    g_d, g_tw = T(rng.standard_normal((R, 1)).astype(np.float32)), \
        T(rng.standard_normal((R, Kc)).astype(np.float32))
    ins = [T(dens).requires_grad_(True), T(nrm).requires_grad_(True)]
    outs = tvr.weights_topk_plain(T(z), *ins, Kc)
    g_dens, g_nrm = torch.autograd.grad([outs[1], outs[3]], ins, [g_d, g_tw],
                                        allow_unused=True)
    assert g_nrm is None                      # no cotangent reaches the normals
    c_dens, c_nrm = tvr.weights_topk_bwd_plain(T(z), T(dens), T(nrm), outs[5], None, g_d,
                                               None, g_tw, None)
    np.testing.assert_allclose(c_dens.numpy(), g_dens.numpy(), atol=1e-5, rtol=1e-5)
    assert not c_nrm.any()


# ---------------------------------------------------------------------------
# numpy emulations of the kernel's pick
# ---------------------------------------------------------------------------

def pick_keys(w: np.ndarray) -> np.ndarray:
    """composite.cu pick_key: (~weight bits) << 32 | index, as uint64."""
    bits = w.astype(np.float32).view(np.uint32)
    return ((~bits).astype(np.uint64) << np.uint64(32)) | np.arange(w.size, dtype=np.uint64)


def stable_desc(w: np.ndarray) -> np.ndarray:
    """The plain version's order: a stable descending sort."""
    return torch.sort(T(w), descending=True, stable=True)[1].numpy()


def pick_radix(w: np.ndarray, Kc: int) -> np.ndarray:
    """composite.cu pick_radix: the Kc-th largest weight's bits tau, bit by
    bit from the top (none when at most Kc weights are non-zero;
    stopping once exactly Kc weights are at or above the prefix); the
    weights above tau and the first ties at tau in index
    order; each pick's place the count of picks with a smaller key."""
    bits = w.astype(np.float32).view(np.uint32)
    tau = 0
    for b in range(30 if (bits != 0).sum() > Kc else -1, -1, -1):
        cand = tau | (1 << b)
        cnt = int((bits >= cand).sum())
        if cnt >= Kc:
            tau = cand
            if cnt == Kc:
                break
    need = Kc - int((bits > tau).sum())
    eq_rank = np.cumsum(bits == tau) - 1
    take = (bits > tau) | ((bits == tau) & (eq_rank < need))
    row = pick_keys(w)[take]
    assert row.size == Kc
    out = np.empty(Kc, np.int64)
    for key in row:
        out[int((row < key).sum())] = int(key & np.uint64(0xFFFFFFFF))
    return out


# weights >= 0 with exact zeros, subnormals, equal values and a few large
_WEIGHT = st.one_of(
    st.just(0.0),
    st.sampled_from([float(np.float32(v)) for v in (1e-45, 3e-42, 1.1754942e-38, 0.25, 0.5, 1.0)]),
    st.floats(min_value=0.0, max_value=float(np.float32(1.2e-38)), width=32),
    st.floats(min_value=0.0, max_value=1.0, width=32),
)


@settings(max_examples=200, deadline=None)
@given(st.lists(_WEIGHT, min_size=1, max_size=128))
def test_pick_keys_sort_as_the_stable_descending_order(ws):
    """Ascending 64-bit keys give the stable descending order of (weight,
    index): ties, exact zeros and subnormals included."""
    w = np.asarray(ws, np.float32)
    np.testing.assert_array_equal(np.argsort(pick_keys(w), kind="stable"), stable_desc(w))


@settings(max_examples=60, deadline=None)
@given(st.lists(_WEIGHT, min_size=1, max_size=128), st.integers(1, 128))
def test_kernel_picks_emulated_match_the_plain_order(ws, Kc):
    """The radix select gives the plain version's first Kc indices."""
    w = np.asarray(ws, np.float32)
    Kc = min(Kc, w.size)
    np.testing.assert_array_equal(pick_radix(w, Kc), stable_desc(w)[:Kc])


@pytest.mark.parametrize("S", [1, 31, 98, 128, 200, 1024])
def test_interleaved_layout_covers_each_float_once(S):
    """The coalesced normal/colour rows: in round j, lane l's m-th float is
    i = 96 j + l + 32 m, component (l + 2 m) % 3 of sample 32 j + (l + 32 m)
    // 3, whose weight lane (l + 32 m) // 3 holds; every float of the ray's
    3 S is met exactly once, with its own component and sample."""
    NR = 4 if S <= 128 else 32
    seen = np.zeros(3 * S, int)
    for j in range(NR):
        for m in range(3):
            for lane in range(32):
                f = lane + 32 * m
                i = 96 * j + f
                if i >= 3 * S:
                    continue
                seen[i] += 1
                assert (lane + 2 * m) % 3 == i % 3
                assert 32 * j + f // 3 == i // 3 and f // 3 < 32
    assert (seen == 1).all()


def test_kernel_shape_limits():
    """The wrappers refuse what the kernels do not take (they have no
    fallback): weights_topk S <= 1024 and 0 < Kc <= S, composite S <= 512,
    topk_rgb Kc >= 1."""
    tvr.check_weights_topk_shape(1024, 1024)
    tvr.check_weights_topk_shape(98, 16)
    tvr.check_weights_topk_shape(1, 1)
    for S, Kc in ((1025, 16), (98, 0), (98, 99), (0, 0), (16, -1)):
        with pytest.raises(ValueError, match="weights_topk kernel"):
            tvr.check_weights_topk_shape(S, Kc)
    tvr.check_composite_shape(512)
    for S in (513, 0):
        with pytest.raises(ValueError, match="composite kernel"):
            tvr.check_composite_shape(S)
    tvr.check_topk_rgb_shape(1)
    with pytest.raises(ValueError, match="topk_rgb kernel"):
        tvr.check_topk_rgb_shape(0)
