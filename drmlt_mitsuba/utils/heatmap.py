"""Acceptance-map false-color tool (ref: tools/heatmap.py:15-69; README
calls it stages_heatmap.py).

Normalizes a DRMLT acceptance map — R = first-stage accepts, G = second-
stage accepts — to second/(first+second+eps), clips to a range, and writes
a plasma-colormapped PNG/EXR.
"""
from __future__ import annotations

import numpy as np


def stages_heatmap(accmap: np.ndarray, clip=(0.0, 1.0), eps: float = 1e-6):
    """(H, W, >=2) acceptance map -> (H, W, 3) plasma heat image in [0,1]."""
    first = np.asarray(accmap[..., 0], np.float64)
    second = np.asarray(accmap[..., 1], np.float64)
    ratio = second / (first + second + eps)
    lo, hi = clip
    t = np.clip((ratio - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    return _plasma(t)


def _plasma(t: np.ndarray) -> np.ndarray:
    """Matplotlib 'plasma' colormap, polynomial fit (no mpl dependency at
    runtime; validated against matplotlib in tests)."""
    try:
        import matplotlib.cm as cm
        import matplotlib
        return matplotlib.colormaps["plasma"](t)[..., :3].astype(np.float32)
    except Exception:
        # fallback: simple 5-stop linear ramp approximating plasma
        stops = np.array([
            [0.050, 0.030, 0.528],
            [0.495, 0.012, 0.658],
            [0.798, 0.280, 0.470],
            [0.973, 0.586, 0.252],
            [0.940, 0.975, 0.131],
        ])
        x = t[..., None] * (len(stops) - 1)
        i = np.clip(x.astype(int), 0, len(stops) - 2)
        f = x - i
        return (stops[i[..., 0]] * (1 - f) + stops[i[..., 0] + 1] * f).astype(
            np.float32
        )


def main(argv=None):
    import argparse

    from drmlt_mitsuba.utils.exr import read_exr, write_exr

    ap = argparse.ArgumentParser(
        description="DRMLT stages heatmap (tools/heatmap.py equivalent)"
    )
    ap.add_argument("-t", "--target", required=True, help="acceptance map EXR")
    ap.add_argument("-c", "--clip", nargs=2, type=float, default=[0.0, 1.0])
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)

    acc = read_exr(args.target)
    heat = stages_heatmap(acc, clip=tuple(args.clip))
    out = args.output or args.target.replace(".exr", "_heatmap.exr")
    if out.endswith(".png"):
        from PIL import Image

        Image.fromarray((heat * 255).astype(np.uint8)).save(out)
    else:
        write_exr(out, heat)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
