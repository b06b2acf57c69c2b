"""The port's preprocessing networks, flows and TSDF fusion against the JAX
package on the CPU, at small sizes.

Tolerances, and why:
  * mono prior (``mono_prior.npz``): float32 against float32, <= 1e-5 abs
    on depth and normals (measured ~1e-6).
  * DPT and GMFlow with random weights from the JAX package's ``init_*``:
    both networks amplify float32 rounding (GroupNorm over 4 x 4 maps, 12
    ViT blocks; GMFlow's peaked global softmax), so each package's float32
    output lies ~1e-2 (DPT, outputs up to ~230) or ~2e-3 px (GMFlow) from
    the exact function. The parity check therefore runs both in float64
    (JAX under ``enable_x64``, the port's modules ``.double()``): DPT
    within rtol 1e-3 / atol 5e-4 and GMFlow within 1e-9 px (measured
    ~1e-11 and ~1e-12). In float32 the port must then stay within 4 times
    the JAX package's own distance from the float64 result.
  * classical flow: <= 1e-9 px (the same float64 operations in the same
    order; equal in practice). Geometric flow, occlusion, normals from
    depth: bit for bit.
  * TSDF fusion at 64³ (the port's plain K9): XLA sums the camera-space
    point's matrix product in its own order, so a voxel whose pixel
    coordinate lies within 1e-4 of a half-integer may pick the other pixel;
    every other voxel agrees within 1e-5 in tsdf and weight. Meshes agree
    in vertex count within 0.5 % and in median radius within 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu.datasets.synthetic import camera_trajectory
from nicer_slam_tpu.models import dpt as jdpt
from nicer_slam_tpu.models import gmflow as jgm
from nicer_slam_tpu.models import mono_prior as jmp
from nicer_slam_tpu.preprocess import extract_flows as jflows
from nicer_slam_tpu.preprocess import extract_monocular_cues as jcues
from nicer_slam_tpu.preprocess import tsdf_fusion as jtsdf
from nicer_slam_tpu.slam.checkpoint import _flatten_pytree
from nicer_slam_tpu_torch.models import dpt as tdpt
from nicer_slam_tpu_torch.models import gmflow as tgm
from nicer_slam_tpu_torch.models import layers
from nicer_slam_tpu_torch.models import mono_prior as tmp
from nicer_slam_tpu_torch.ops import tsdf as ttsdf
from nicer_slam_tpu_torch.preprocess import extract_flows as tflows
from nicer_slam_tpu_torch.preprocess import extract_monocular_cues as tcues
from nicer_slam_tpu_torch.preprocess import tsdf_fusion as tfusion
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MONO_PRIOR = os.path.join(REPO, "mono_prior.npz")
# the port's float32 distance from the float64 result, in units of the JAX
# package's own
F32_FACTOR = 4.0


def _flat(params):
    return {k: np.asarray(v) for k, v in _flatten_pytree(params).items()}


def _f64(params):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)


def _smooth_image(H, W, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (H, W))
    for _ in range(3):
        base = (np.roll(base, 1, 0) + np.roll(base, -1, 0) + np.roll(base, 1, 1)
                + np.roll(base, -1, 1) + base) / 5.0
    return np.clip(np.stack([base, 0.9 * base, 1.1 * base], -1), 0, 1).astype(np.float32)


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------

def test_mono_prior_matches_on_the_shipped_weights():
    """MonoPriorInference on a 30 x 46 frame (edge-padded to 32 x 48)."""
    img = _smooth_image(30, 46, seed=0)
    dj, nj = jmp.MonoPriorInference(MONO_PRIOR)(img)
    dt, nt = tmp.MonoPriorInference(MONO_PRIOR, device="cpu")(img)
    assert dt.shape == (30, 46) and nt.shape == (3, 30, 46)
    assert np.abs(dt - dj).max() <= 1e-5 and np.abs(nt - nj).max() <= 1e-5


def test_flat_layout_round_trips():
    """mono_prior.npz -> the port's module -> to_flat: every array back bit
    for bit; a missing or an extra key is refused."""
    with np.load(MONO_PRIOR) as d:
        flat = {k: d[k] for k in d.files}
    back = layers.to_flat(layers.load_flat_npz(tmp.MonoPrior(), flat))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    with pytest.raises(KeyError):
        layers.load_flat_npz(tmp.MonoPrior(), {k: v for k, v in flat.items()
                                              if k != "head_depth/b"})
    with pytest.raises(KeyError):
        layers.load_flat_npz(tmp.MonoPrior(), dict(flat, extra=np.zeros(1)))


def test_resize_matches_jax_image_resize():
    """DPTInference's resizes at the full-size ratio: 680 x 1200 -> 384² (JAX
    antialiases when it shrinks) and back. The weights are JAX's to float32
    rounding; the images agree within 5e-5 (XLA:CPU's contraction of the
    same weights lies 1.5e-5 from their exact float64 contraction when it
    enlarges, the port's 1.1e-7)."""
    x = np.random.default_rng(1).uniform(0, 1, (1, 680, 1200, 3)).astype(np.float32)
    for src, (h, w) in ((x, (384, 384)), (x[:, :384, :384], (680, 1200))):
        ref = np.asarray(jax.image.resize(jnp.asarray(src), (1, h, w, 3), "bilinear"))
        got = layers.resize_bilinear(torch.from_numpy(src).permute(0, 3, 1, 2), h, w)
        assert np.abs(got.permute(0, 2, 3, 1).numpy() - ref).max() <= 5e-5


@pytest.mark.parametrize("out_channels", [1, 3], ids=["depth", "normal"])
def test_dpt_matches(out_channels):
    """init_dpt(features=32, dim=48, depth=12) carried across, 64 x 64."""
    p = jdpt.init_dpt(rng_seed=out_channels, out_channels=out_channels, features=32,
                      dim=48, depth=12)
    img = np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3))
    model = layers.load_flat_npz(tdpt.DPT(out_channels, features=32, dim=48, depth=12),
                                 _flat(p))
    with jax.enable_x64(True):
        ref64 = np.asarray(jax.jit(lambda q, x: jdpt.dpt_forward(q, x, out_channels))(
            _f64(p), jnp.asarray(img)))
    ref32 = np.asarray(jax.jit(lambda q, x: jdpt.dpt_forward(q, x, out_channels))(
        p, jnp.asarray(img, jnp.float32)))
    with torch.no_grad():
        got64 = model.double()(torch.from_numpy(img)).numpy()
        got32 = model.float()(torch.from_numpy(img).float()).numpy()
    assert got64.shape == (1, 64, 64, out_channels)
    np.testing.assert_allclose(got64, ref64, rtol=1e-3, atol=5e-4)
    assert np.abs(got32 - ref64).max() <= F32_FACTOR * np.abs(ref32 - ref64).max()


def test_dpt_inference_reads_a_flat_checkpoint(tmp_path):
    """DPTInference takes its widths from the npz, resizes to input_size and
    back, and normalises depth to [0, 1]; the normal head is [3, H, W] in
    [0, 1] up to the resize's float32 rounding."""
    img = _smooth_image(40, 56, seed=3)
    for task, oc in (("depth", 1), ("normal", 3)):
        path = str(tmp_path / f"dpt_{task}.npz")
        net = layers.init_seeded(tdpt.DPT(oc, features=32, dim=48, depth=12), seed=oc)
        np.savez(path, **layers.to_flat(net))
        out = tdpt.DPTInference(path, task, device="cpu", input_size=64)(img)
        assert out.shape == ((40, 56) if oc == 1 else (3, 40, 56))
        assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1 + 1e-6
    with pytest.raises(ValueError):
        tdpt.DPTInference(str(tmp_path / "dpt_depth.npz"), "normal", device="cpu")


def test_gmflow_matches():
    """init_gmflow(dim=32, num_blocks=2) carried across, 64 x 96."""
    p = jgm.init_gmflow(rng_seed=1, dim=32, num_blocks=2)
    a = _smooth_image(64, 96, seed=4).astype(np.float64)
    b = np.roll(a, (1, 2), (0, 1))
    model = layers.load_flat_npz(tgm.GMFlow(dim=32, num_blocks=2), _flat(p))
    with jax.enable_x64(True):
        ref64 = np.asarray(jax.jit(jgm.gmflow_forward)(_f64(p), jnp.asarray(a[None]),
                                                        jnp.asarray(b[None])))
    ref32 = np.asarray(jax.jit(jgm.gmflow_forward)(
        p, jnp.asarray(a[None], jnp.float32), jnp.asarray(b[None], jnp.float32)))
    with torch.no_grad():
        got64 = model.double()(torch.from_numpy(a[None]), torch.from_numpy(b[None])).numpy()
        got32 = model.float()(torch.from_numpy(a[None]).float(),
                              torch.from_numpy(b[None]).float()).numpy()
    assert got64.shape == (1, 64, 96, 2)
    assert np.abs(got64 - ref64).max() <= 1e-9
    assert np.abs(got32 - ref64).max() <= F32_FACTOR * np.abs(ref32 - ref64).max()


def test_gmflow_inference_pads_to_32(tmp_path):
    """A 50 x 70 pair is zero-padded to 64 x 96 and the flow cropped: the
    network on the padded pair, cropped."""
    net = layers.init_seeded(tgm.GMFlow(dim=32, num_blocks=1), seed=5)
    path = str(tmp_path / "gmflow.npz")
    np.savez(path, **layers.to_flat(net))
    a, b = _smooth_image(50, 70, seed=6), _smooth_image(50, 70, seed=7)
    flow = tgm.GMFlowInference(path, device="cpu")(a, b)
    pad = ((0, 14), (0, 26), (0, 0))
    with torch.no_grad():
        ref = net(torch.from_numpy(np.pad(a, pad))[None],
                  torch.from_numpy(np.pad(b, pad))[None])[0, :50, :70].numpy()
    assert flow.shape == (50, 70, 2)
    np.testing.assert_array_equal(flow, ref)


# ---------------------------------------------------------------------------
# flows and cues
# ---------------------------------------------------------------------------

def test_classical_flow_matches():
    """80 x 104, a shifted smooth texture: 4 pyramid levels, 3 warps of 26
    iterations each."""
    a = _smooth_image(80, 104, seed=2)
    b = np.roll(a, (1, 3), (0, 1))
    ref = jflows.classical_flow(a, b)
    got = tflows.classical_flow(a, b, device="cpu")
    assert got.dtype == np.float32 and got.shape == (80, 104, 2)
    assert np.abs(ref).max() > 1.0
    assert np.abs(got.astype(np.float64) - ref).max() <= 1e-9


def test_numpy_helpers_are_the_same_bits():
    """np.gradient's edges as tensor ops; the geometric flow, its occlusion
    and normals_from_depth (numpy copies) bit for bit."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((7, 9))
    for dim in (0, 1):
        np.testing.assert_array_equal(tflows._gradient(torch.from_numpy(a), dim).numpy(),
                                      np.gradient(a, axis=dim))
    H, W = 30, 40
    K = np.array([[35.0, 0, 19.5], [0, 35.0, 14.5], [0, 0, 1]])
    poses = camera_trajectory(11)
    di = 1.5 + 0.3 * rng.uniform(0, 1, (H, W))
    dj = 1.5 + 0.3 * rng.uniform(0, 1, (H, W))
    for mod_out in zip(jflows.occlusion_from_depth(di, dj, poses[0], poses[10], K),
                       tflows.occlusion_from_depth(di, dj, poses[0], poses[10], K)):
        np.testing.assert_array_equal(*mod_out)
    di[3:5, 4:9] = 0
    np.testing.assert_array_equal(tcues.normals_from_depth(di, 35.0, 35.0),
                                  jcues.normals_from_depth(di, 35.0, 35.0))


# ---------------------------------------------------------------------------
# TSDF fusion
# ---------------------------------------------------------------------------

def _sphere_views(n=8, H=60, W=80):
    """Depth renders of the inside of a sphere of radius 0.9 from the
    synthetic orbit (tests/test_fastio_and_preprocess.py's scene)."""
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    depths, poses = [], []
    for c2w in camera_trajectory(n):
        ys, xs = np.mgrid[0:H, 0:W]
        d_cam = np.stack([(xs - W / 2) / f, (ys - H / 2) / f, np.ones_like(xs, float)], -1)
        d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
        dirs = d_cam @ c2w[:3, :3].T
        o = c2w[:3, 3]
        b = 2 * (dirs @ o)
        c = (o @ o) - 0.81
        t = (-b + np.sqrt(b * b - 4 * c)) / 2
        depths.append((t.reshape(H, W) * d_cam[..., 2]).astype(np.float32))
        poses.append(c2w)
    return depths, np.stack(poses), K


def test_tsdf_fusion_matches():
    depths, poses, K = _sphere_views()
    res, lo, hi, depth_max = 64, np.full(3, -1.0), np.full(3, 1.0), 3.0
    trunc = 4.0 * 2.0 / res
    integ, grid = jtsdf.make_integrate_fn(res, lo, hi, trunc, depth_max)
    jt, jw = jnp.ones((res ** 3,), jnp.float32), jnp.zeros((res ** 3,), jnp.float32)
    coords = ttsdf.axis_coords(res, lo, hi, "cpu")
    tt, tw = torch.ones(res ** 3), torch.zeros(res ** 3)
    K32 = K.astype(np.float32)
    near_half = np.zeros(res ** 3, bool)
    pts = grid.reshape(-1, 3).astype(np.float64)
    for d, c2w in zip(depths, poses):
        w2c = np.linalg.inv(c2w).astype(np.float32)
        jt, jw = integ(jt, jw, jnp.asarray(d), jnp.asarray(w2c), jnp.asarray(K32))
        ttsdf.integrate(tt, tw, torch.from_numpy(d), torch.from_numpy(w2c),
                        torch.from_numpy(K32), coords, trunc, depth_max)
        cam = pts @ w2c[:3, :3].T.astype(np.float64) + w2c[:3, 3]
        pix = [K32[a, a] * cam[:, a] / cam[:, 2] + K32[a, 2] for a in (0, 1)]
        in_frame = ((cam[:, 2] > 0) & (pix[0] > -0.5) & (pix[0] < d.shape[1] - 0.5)
                    & (pix[1] > -0.5) & (pix[1] < d.shape[0] - 0.5))
        for p in pix:
            near_half |= in_frame & (np.abs(p - np.floor(p) - 0.5) < 1e-4)
    jt, jw = np.asarray(jt), np.asarray(jw)
    keep = ~near_half
    assert near_half.mean() <= 1e-3
    assert (jw > 0).sum() > 10_000
    assert np.abs(tt.numpy() - jt)[keep].max() <= 1e-5
    assert np.abs(tw.numpy() - jw)[keep].max() <= 1e-5

    kw = dict(res=res, bounds=(lo, hi), depth_max=depth_max)
    vj, _, _ = jtsdf.fuse_depths(depths, poses, K, **kw)
    vt, ft, nt = tfusion.fuse_depths(depths, poses, K, device="cpu", **kw)
    assert len(vt) > 1000 and len(ft) > 1000 and nt.shape == vt.shape
    assert abs(len(vt) - len(vj)) <= 0.005 * len(vj)
    rj, rt = np.median(np.linalg.norm(vj, axis=-1)), np.median(np.linalg.norm(vt, axis=-1))
    assert abs(rt - rj) <= 1e-4 and abs(rt - 0.9) < 0.06


def test_tsdf_integrate_refuses_other_devices():
    """A wrapper runs its plain version only for a CPU tensor."""
    t = torch.ones(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ttsdf.integrate(t, t, t.view(2, 4), t, t, [t[:2]] * 3, 0.1, 1.0)


def test_background_writer_waits_and_raises(tmp_path):
    """Every write submitted is on disk when the block ends (more writes than
    it keeps pending), and the first failed write raises there."""
    from nicer_slam_tpu_torch.preprocess.common import BackgroundWriter

    def write(i):
        (tmp_path / f"{i}.txt").write_text(str(i))

    with BackgroundWriter(workers=2) as w:
        for i in range(9):
            w.submit(write, i)
    assert sorted(int(p.stem) for p in tmp_path.glob("*.txt")) == list(range(9))
    with pytest.raises(FileNotFoundError):
        with BackgroundWriter(workers=2) as w:
            w.submit(lambda: open(tmp_path / "missing" / "x.txt", "w"))
