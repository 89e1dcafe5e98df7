"""Summary of a training run's per-step JSONL log (``python -m
surf_tpu_torch.train_synthetic --log_jsonl``): the steady steps' times
and their histogram, the loss and PSNR trajectories and their windowed
means, printed as tools/summarize_run.py prints them (numpy only).

    python -m surf_tpu_torch.summarize_run <jsonl>
"""

from __future__ import annotations

import json
import sys

import numpy as np


def main(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    if not rows:
        print("empty log")
        return
    t = np.array([r["t"] for r in rows])
    loss = np.array([r["loss"] for r in rows])
    psnr = np.array([r["psnr"] for r in rows])
    steps = np.array([r["step"] for r in rows])

    # step 0 carries the first launches and the kernels' build; the
    # histogram is of the steady steps
    steady = t[1:] if len(t) > 1 else t
    print(f"steps: {len(rows)} (step {steps[0]}..{steps[-1]})")
    print(f"step 0 (incl. compiles): {t[0]:.1f} s")
    print(f"steady s/step: mean {steady.mean():.2f}  median "
          f"{np.median(steady):.2f}  p5 {np.percentile(steady, 5):.2f}  "
          f"p95 {np.percentile(steady, 95):.2f}  max {steady.max():.2f}")
    hist, bins = np.histogram(steady, bins=10)
    print("histogram (steady steps):")
    for c, lo, hi in zip(hist, bins[:-1], bins[1:]):
        bar = "#" * int(round(60 * c / max(hist.max(), 1)))
        print(f"  [{lo:7.2f}, {hi:7.2f}) {c:4d} {bar}")

    def traj(a, name):
        k = max(len(a) // 8, 1)
        pts = [f"{a[i]:.3f}@{steps[i]}" for i in range(0, len(a), k)]
        if (len(a) - 1) % k:
            pts.append(f"{a[-1]:.3f}@{steps[-1]}")
        print(f"{name}: " + " -> ".join(pts))

    traj(loss, "loss")
    traj(psnr, "psnr")
    # windowed means show the trend through the ray sampling's noise
    w = max(len(loss) // 6, 1)
    lm = [round(float(loss[i:i + w].mean()), 3) for i in range(0, len(loss), w)]
    pm = [round(float(psnr[i:i + w].mean()), 3) for i in range(0, len(psnr), w)]
    print(f"loss window-means (w={w}): {lm}")
    print(f"psnr window-means (w={w}): {pm}")


if __name__ == "__main__":
    main(sys.argv[1])
