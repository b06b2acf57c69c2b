"""Runs of the JAX package through its CLI, each followed by its checkpoint
battery (tools/eval_checkpoint.py), one seed after another, in a fresh
interpreter on the CPU.

  python tests/_jax_eval_run_main.py <conf> <root_dir> <mesh_res> <seed>...

writes <root_dir>/jax<seed>.json per seed. tests/test_torch_eval_e2e.py
spawns it beside the port's CLIs, so that the two packages' runs proceed at
once. The runs share a compile cache of their own under <root_dir> (the
second seed's run loads the first one's programs; the battery's module
would set a directory of its own, and that call is skipped).
"""

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, REPO)

from _jax_cpu_env import setup_cpu_jax  # noqa: E402

setup_cpu_jax()

import jax  # noqa: E402


def main(conf, root_dir, mesh_res, *seeds):
    from nicer_slam_tpu.training import exp_runner

    jax.config.update("jax_compilation_cache_dir", os.path.join(root_dir, "jax_cache"))
    spec = importlib.util.spec_from_file_location(
        "eval_checkpoint", os.path.join(REPO, "tools", "eval_checkpoint.py"))
    battery = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(battery)
    update = jax.config.update
    jax.config.update = lambda k, v: None if k == "jax_compilation_cache_dir" else update(k, v)
    for seed in seeds:
        run_root = os.path.join(root_dir, f"jax{seed}")
        exp_runner.main(["--conf", conf, "--root_dir", run_root, "--seed", seed])
        exps = os.path.join(run_root, "exps")
        (exp,) = os.listdir(exps)
        (stamp,) = os.listdir(os.path.join(exps, exp))
        battery.main(["--rundir", os.path.join(exps, exp, stamp), "--mesh_res", mesh_res,
                      "--out", os.path.join(root_dir, f"jax{seed}.json"),
                      "--synthetic_gt_mesh"])


if __name__ == "__main__":
    main(*sys.argv[1:])
