"""The JAX package's two-device sharded map_step on the case of
tests/_torch_parallel_case.py, for tests/test_torch_parallel.py.

Run as a script in a fresh interpreter (as tests/_multichip_equiv_main.py
is, for the same reason: XLA:CPU's collectives are safest in a process of
their own):

  python tests/_torch_parallel_jax_main.py IN.npz OUT.npz

IN.npz holds the case's arrays and the draw's key; OUT.npz gets the loss
terms (term/<name>), the voxel counter, the poses and the first Adam
moment of every parameter (mu/<path>).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _jax_cpu_env import setup_cpu_jax  # noqa: E402

setup_cpu_jax()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _adam_mu(opt_state):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [getattr(k, "name", getattr(k, "key", getattr(k, "idx", None)))
                 for k in path]
        if "mu" in names:
            out["/".join(str(n) for n in names[names.index("mu") + 1:])] = np.asarray(leaf)
    return out


def main(in_path, out_path):
    from nicer_slam_tpu.parallel.mesh import make_mesh, ray_sharding
    from nicer_slam_tpu.slam import mapping as jmap
    from nicer_slam_tpu.slam import state as jstate

    import _torch_parallel_case as case
    import _torch_tiny
    from test_torch_ops import _blocked_cache

    a = dict(np.load(in_path))
    jcfg, tcfg, jloss, _ = _torch_tiny.configs(case.H, case.W, n_images=case.N_IMAGES)
    jparams = _torch_tiny.models(jcfg, tcfg)[0]
    map_j = jmap.MapConfig(num_pixels=case.R, max_slots=case.SMAX, max_edges=2,
                           BA_cam_lr=1e-3)
    refs = jmap.MapBatchRefs(
        slot_rows=jnp.asarray(case.SLOT_ROWS, jnp.int32),
        frame_ids=jnp.asarray(case.FRAME_IDS, jnp.int32), n_valid=jnp.asarray(2, jnp.int32),
        intrinsics=jnp.asarray(a["intr"]), edge_idii=jnp.asarray([0, 1], jnp.int32),
        edge_idjj=jnp.asarray([1, 0], jnp.int32), edge_valid=jnp.asarray([True, True]),
        flow_imgs=jnp.asarray(a["flows"]), flow_occ=jnp.asarray(a["occ"]),
        slot_conf=jnp.asarray(case.SLOT_CONF))
    optimizer = jstate.make_optimizer(jstate.OptimConfig(**case.OPTIM), jparams)
    mesh = make_mesh(2)
    with mesh:
        p, st, vox, q, terms = jmap.map_step(
            jcfg, map_j, jloss[0], jparams, optimizer.init(jparams), jnp.asarray(a["vox"]),
            optimizer, jnp.asarray(a["q"]), refs, jnp.asarray(a["rgb"]),
            jnp.asarray(a["depth"]), jnp.asarray(a["normal"]), jnp.asarray(a["gt_depth"]),
            jnp.asarray(a["mask"]), jax.random.PRNGKey(int(a["key"])),
            jnp.asarray(_blocked_cache(a["cache"])), None, stage="fine",
            color_stage="highfreq", ba=True, is_first_frame=False, use_flow=True,
            shard_rays=ray_sharding(mesh))
    out = {"voxels": np.asarray(vox), "q": np.asarray(q)}
    out.update({"term/" + k: np.asarray(v) for k, v in terms.items()})
    out.update({"mu/" + k: v for k, v in _adam_mu(st).items()})
    np.savez(out_path, **out)
    print(f"SHARDED OK n_devices={mesh.size} loss={float(terms['loss']):.6f}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
