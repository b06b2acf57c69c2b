"""The JAX package's encode of tests/_torch_sharded_case.py on one device
and in its ``sharded`` collective mode on two, for
tests/test_torch_sharded.py.

Run as a script in a fresh interpreter (XLA:CPU's collectives are safest
in a process of their own, as tests/_grid_collectives_main.py runs them):

  python tests/_torch_sharded_jax_main.py IN.npz OUT.npz

IN.npz holds the case's table ([C, T]), points and output weights;
OUT.npz gets the loss and the table gradient ([C, T]) of the one-device
(replicated) encode (f0, g0) and of the sharded one (f2, g2, and the
points' gradient gx2).
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


def main(in_path, out_path):
    from nicer_slam_tpu.ops import hash_encoder as he
    from nicer_slam_tpu.parallel.mesh import make_mesh

    import _torch_sharded_case as case

    a = dict(np.load(in_path))
    he.SORTED_BWD_MIN_ENTRIES = case.MIN_ENTRIES
    he.GRID_SHARD_MIN_ENTRIES = case.MIN_ENTRIES
    spec = he.make_spec(3, **case.SPEC)
    emb, x, w_out = (jnp.asarray(a[k]) for k in ("emb", "x", "w_out"))

    def loss_fn(e, x):
        return (he.hash_encode(spec, e, x) * w_out).sum()

    out = {}
    he.GRID_SHARD_MESH = None
    he.GRID_COLLECTIVE_MODE = "replicated"
    f0, g0 = jax.jit(jax.value_and_grad(loss_fn))(emb, x)
    out.update(f0=np.asarray(f0), g0=np.asarray(g0))
    mesh = make_mesh(case.WORLD)
    he.GRID_SHARD_MESH = mesh
    he.GRID_COLLECTIVE_MODE = "sharded"
    assert he._collective_mode_applies(spec, "sharded", x.shape[0])
    f2, (g2, gx2) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(emb, x)
    out.update(f2=np.asarray(f2), g2=np.asarray(g2), gx2=np.asarray(gx2))
    he.GRID_SHARD_MESH = None
    he.GRID_COLLECTIVE_MODE = "replicated"
    np.savez(out_path, **out)
    print(f"SHARDED ENCODE OK n_devices={mesh.size} f2={float(f2):.6f}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
