#!/usr/bin/env python3
"""Where K6's general kernel spends its time: copies of this checkout's
``csrc/sdf_density.cu`` that each leave one part out, timed against it in
turns by ``tools/sdf_density_ab.py`` on one CUDA card.

  python3 tools/sdf_density_ablate.py [--only SUBSTRING] [--out FILE]

The copies go under ``build/sdf_ablate/<name>/`` (the whole package, so
each side packs its own weights): ``nogather`` (every grid feature 0, as
for a point outside the grid), ``nope`` (no sines and cosines in the
positional encoding), ``nocopy`` (the weight ring's slices copied for the
first tile only; later tiles complete their mbarriers without a copy) and
``nosoftplus`` (the hidden layers' activation the identity). Their outputs
are wrong by design; only their times are read, beside this checkout's,
which must agree with the plain version. ``--only`` (default: concat at
2580 x 640 and the 8 x 256 network) picks the cases as in
``sdf_density_ab.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import sdf_density_ab  # noqa: E402

SRC = os.path.join(ROOT, "nicer_slam_tpu_torch", "csrc", "sdf_density.cu")

# name -> (text in csrc/sdf_density.cu, its replacement)
ABLATIONS = {
    "nogather": ("    if (nsl::level_geom(xp, 1.0f, __ldg(scl + 2 * l), 0.0f, geo)) {",
                 "    if (nsl::level_geom(xp, 1.0f, __ldg(scl + 2 * l), 0.0f, geo) || true) {"),
    "nope": ("        sincosf(x * (float)(1 << (f - 1)), &s, &co);", "        s = co = x;"),
    "nocopy": ("""  bulk_copy(ring + st * g.stage, g.p.weights + s.off + (int64_t)cur->row * s.n, bytes,
            full + st);""", """  if (cur->tile == blockIdx.x)
    bulk_copy(ring + st * g.stage, g.p.weights + s.off + (int64_t)cur->row * s.n, bytes,
              full + st);
  else
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(smem_addr(full + st))
                 : "memory");"""),
    "nosoftplus": ("        if (act) v[i] = softplus100(v[i]);", "        (void)act;"),
}


def make_variants() -> list:
    src = open(SRC).read()
    dirs = []
    for name, (old, new) in ABLATIONS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: its text is not in {SRC} exactly once")
        d = os.path.join(ROOT, "build", "sdf_ablate", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "nicer_slam_tpu_torch"),
                        os.path.join(d, "nicer_slam_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        with open(os.path.join(d, "nicer_slam_tpu_torch", "csrc", "sdf_density.cu"), "w") as f:
            f.write(src.replace(old, new))
        dirs.append(d)
    return dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", action="append", default=None)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sdf_density_ablate.json"))
    args = ap.parse_args(argv)
    dirs = make_variants()
    rows = []
    for only in args.only or ["concat 2580", "volsdf"]:
        out = f"{args.out}.{len(rows)}"
        sdf_density_ab.main(sum((["--other", d] for d in dirs), [])
                            + ["--only", only, "--out", out])
        with open(out) as f:
            rows += json.load(f)["cases"]
    with open(args.out, "w") as f:
        json.dump({"ablations": list(ABLATIONS), "cases": rows}, f, indent=1)
    tol = sdf_density_ab.chip_smoke.SDF_DENSITY_RTOL
    return 0 if rows and all(r["rel_err_vs_plain"]["this"] <= tol for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
