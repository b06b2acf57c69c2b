"""nicer_slam_tpu_torch — the SLAM main path of nicer_slam_tpu in PyTorch,
for one NVIDIA H100.

The JAX package ``nicer_slam_tpu`` is the reference; this package keeps its
layout and module names so each module's counterpart sits at the same path:

  ops/        hash encoder (K1/K2), embedder, density, ray sampling (K5),
              volume rendering (K4), and the CUDA build/launch helpers
  models/     weight-normed linears, SDF/color fields, the scene model,
              the loss stack
  slam/       optimizer state, tracking, mapping, frame store, checkpoints,
              the runner
  datasets/   the VolSDF on-disk loader
  training/   the exp_runner CLI
  utils/      camera math, a CUDA-synchronising phase timer
  csrc/       the hand-written Hopper kernels (CUDA C++, sm_90a)

The package imports ``torch`` and never ``jax``. The jax-free modules of the
reference package (config, synthetic dataset, keyframe selection, fastio)
are imported from it, not copied.

Every kernel wrapper runs its plain PyTorch version for a CPU tensor and
launches its CUDA kernel for a CUDA tensor; there is no fallback from one
to the other.
"""

__version__ = "0.1.0"
