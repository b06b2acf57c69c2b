"""Runs of the port repeat bit for bit without any process-wide torch
setting: no module of nicer_slam_tpu_torch turns on torch's deterministic
algorithms or sets cuBLAS's workspace, building a runner leaves both as
they were, and each sum that the paths once left to float atomics
(``losses._segment_sum``, an index_add on the card) has a fixed order.
On the card, chip_smoke.py runs the demo path twice and holds the two runs
equal bit for bit.

Tolerances (each stated where it is used): the fixed-order segment sum
within 1e-6 of the largest |value| of jax.ops.segment_sum (the packages
sum in other orders), its gradient and two of its calls bit for bit.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu_torch.models import losses as tl
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "nicer_slam_tpu_torch")
PROCESS_WIDE = ("use_deterministic_algorithms", "CUBLAS_WORKSPACE_CONFIG",
                "fill_uninitialized_memory")


def test_no_module_sets_process_wide_torch_state():
    """Source scan: no file of the port names torch's deterministic mode,
    its fresh-memory fill or cuBLAS's workspace variable."""
    files = sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True))
    bad = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                bad += [(os.path.relpath(path, REPO), i, w) for w in PROCESS_WIDE
                        if w in line]
    assert len(files) > 30 and not bad, bad


def test_building_a_runner_leaves_torch_state_as_it_was(tmp_path):
    """A SLAMRunner built on the CPU from a tiny conf changes neither
    torch's deterministic mode, nor its fresh-memory fill, nor the cuBLAS
    workspace variable."""
    from nicer_slam_tpu_torch.datasets.synthetic import generate
    from nicer_slam_tpu_torch.slam.runner import SLAMRunner
    from test_torch_slice import _tiny_conf

    data_dir = str(tmp_path / "Synthetic")
    generate(data_dir, scan_id=1, n_frames=2, H=24, W=32, keyframe_every=1)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.utils.deterministic.fill_uninitialized_memory,
              os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    r = SLAMRunner(conf=_tiny_conf(tmp_path, data_dir, 2), root_dir=str(tmp_path),
                   quiet=True, device="cpu")
    assert r.n_images == 2
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory,
            os.environ.get("CUBLAS_WORKSPACE_CONFIG")) == before


def _segments(n: int, rows: int = 257, seed: int = 0):
    """rows values with ids in [0, n), drawn from a seed; for n > 1
    segment n // 2 is empty."""
    rng = np.random.default_rng(seed + n)
    ids = rng.integers(0, n, rows)
    if n > 1:
        ids[ids == n // 2] = (n // 2 + 1) % n
    v = rng.normal(size=rows).astype(np.float32) * 10.0
    return v, ids.astype(np.int64)


@pytest.mark.parametrize("n", [1, 3, 15])
def test_segment_sum_matches_jax_and_repeats(n):
    """The one-hot segment sum equals jax.ops.segment_sum within 1e-6 of
    the largest |sum| (other summation orders), an empty segment sums to
    exactly 0, two calls agree bit for bit, and its gradient equals
    autograd through the plain gather w[seg] bit for bit."""
    v, ids = _segments(n)
    got = tl._segment_sum(torch.from_numpy(v), torch.from_numpy(ids), n).numpy()
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(ids), num_segments=n))
    assert got.shape == (n,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    if n > 1:
        assert got[n // 2] == 0.0 and not (ids == n // 2).any()
    again = tl._segment_sum(torch.from_numpy(v), torch.from_numpy(ids), n).numpy()
    assert got.tobytes() == again.tobytes()
    w = torch.from_numpy(np.random.default_rng(n).normal(size=n).astype(np.float32))
    vt = torch.from_numpy(v).requires_grad_(True)
    (g,) = torch.autograd.grad((tl._segment_sum(vt, torch.from_numpy(ids), n) * w).sum(), vt)
    np.testing.assert_array_equal(g.numpy(), w[torch.from_numpy(ids)].numpy())


def test_segment_sum_keeps_a_non_finite_value_in_its_segment():
    """A non-finite value reaches its own segment's sum and no other's
    (a select, not a multiply by the one-hot mask)."""
    v, ids = _segments(3)
    v[0] = np.inf
    got = tl._segment_sum(torch.from_numpy(v), torch.from_numpy(ids), 3).numpy()
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(ids), num_segments=3))
    assert np.isinf(got[ids[0]]) and np.isinf(ref[ids[0]])
    others = np.arange(3) != ids[0]
    assert np.isfinite(got[others]).all()
    np.testing.assert_allclose(got[others], ref[others], rtol=0,
                               atol=1e-6 * np.abs(ref[others]).max())
