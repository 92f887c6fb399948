"""Image utilities (ref: src/utils/{tonemap,addimages}.cpp and the
`avg` misc integrator that averages EXR stacks — the equal-time comparison
toolchain from SURVEY §4)."""
from __future__ import annotations

import argparse
import sys

import numpy as np


def cmd_avg(args):
    from drmlt_mitsuba.utils.exr import read_exr, write_exr

    imgs = [read_exr(p) for p in args.inputs]
    out = np.mean(np.stack(imgs), axis=0)
    write_exr(args.output, out)
    print(f"averaged {len(imgs)} images -> {args.output}")


def cmd_add(args):
    from drmlt_mitsuba.utils.exr import read_exr, write_exr

    a = read_exr(args.inputs[0]) * args.weight_a
    b = read_exr(args.inputs[1]) * args.weight_b
    write_exr(args.output, a + b)
    print(f"wrote {args.output}")


def cmd_tonemap(args):
    from PIL import Image

    from drmlt_mitsuba.utils.exr import read_exr

    img = read_exr(args.inputs[0]) * (2.0 ** args.exposure)
    if args.reinhard:
        img = img / (1.0 + img)
    img = np.clip(img, 0.0, 1.0)
    srgb = np.where(img <= 0.0031308, img * 12.92,
                    1.055 * np.maximum(img, 1e-8) ** (1 / 2.4) - 0.055)
    Image.fromarray((srgb * 255).astype(np.uint8)).save(args.output)
    print(f"wrote {args.output}")


def cmd_rmse(args):
    from drmlt_mitsuba.utils.exr import read_exr

    a = read_exr(args.inputs[0])
    b = read_exr(args.inputs[1])
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    rel = rmse / max(float(np.abs(b).mean()), 1e-9)
    print(f"rmse={rmse:.6f} relative={rel:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="drmlt-img")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("avg", help="average a stack of EXRs")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_avg)
    p = sub.add_parser("add", help="weighted sum of two EXRs")
    p.add_argument("inputs", nargs=2)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--weight-a", type=float, default=1.0)
    p.add_argument("--weight-b", type=float, default=1.0)
    p.set_defaults(fn=cmd_add)
    p = sub.add_parser("tonemap", help="EXR -> PNG with sRGB + exposure")
    p.add_argument("inputs", nargs=1)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-e", "--exposure", type=float, default=0.0)
    p.add_argument("--reinhard", action="store_true")
    p.set_defaults(fn=cmd_tonemap)
    p = sub.add_parser("rmse", help="RMSE between two EXRs")
    p.add_argument("inputs", nargs=2)
    p.set_defaults(fn=cmd_rmse)
    args = ap.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
