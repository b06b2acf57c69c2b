#!/usr/bin/env python3
"""Profile the port's DPT forward (seeded weights, 384², depth head) on one
CUDA card.

  python3 tools/torch_dpt_profile.py

Prints the card's name and power limit, the forward's time alone (CUDA
events, mean of 5 after 3, TF32 off), the 12 operators of one forward with
the most device time under ``torch.profiler``, and the forward's time with
``cudnn.benchmark`` on. The other device work of the preprocessing layer is
measured by ``chip_smoke.py`` (phases 3 and 8).
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def forward_ms(net, x) -> float:
    for _ in range(3):
        net(x)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    for _ in range(5):
        net(x)
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / 5


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_dpt_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from nicer_slam_tpu_torch.models import dpt
    from nicer_slam_tpu_torch.models.layers import init_seeded

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    net = init_seeded(dpt.DPT(1), 2).to(dev).eval()
    x = torch.rand(1, 384, 384, 3, device=dev)
    with torch.no_grad():
        print("dpt forward ms", forward_ms(net, x), flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            net(x)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12,
                                        max_name_column_width=70), flush=True)
        torch.backends.cudnn.benchmark = True
        print("dpt forward ms with cudnn.benchmark", forward_ms(net, x), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
