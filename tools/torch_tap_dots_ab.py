#!/usr/bin/env python3
"""B2 (the MSD's tap-window kernel) of one checkout at every distinct shape
of a v1 GAN step, to hold two checkouts' outputs and times side by side on
one card.

    python3 tools/torch_tap_dots_ab.py --root DIR --save OUT.pt [--dtype f32|bf16]
    python3 tools/torch_tap_dots_ab.py --compare A.pt B.pt

The first form imports ``neuraltexttospeech_torch`` from DIR, runs
``gouter_tap_dots_kernel`` on seeded inputs (the same in every checkout) at
the 15 forward and 15 dx shapes of ``chip_smoke.py::msd_tap_shapes(16,
8192)`` and saves each output's SHA-256 with its device time (the
profiler's busy time over 5 calls). The second prints, per shape, whether
the two outputs are equal bit for bit and both times, and exits 1 if any
differs.
"""

import argparse
import hashlib
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run(root, save, dtype):
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(root))
    from neuraltexttospeech_torch.ops import gouter_kernel

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda", 0)
    out = {"card": card, "root": str(root), "dtype": dtype, "shapes": []}
    for scale, layer, fwd, dx in chip_smoke.msd_tap_shapes(16, 8192):
        for kind, shape, flip_t in (("fwd", fwd, False), ("dx", dx, True)):
            g, b, qp, x_dim, y_dim, kf, s, q = shape
            rng = np.random.default_rng(100 * scale + 10 * layer + (kind == "dx"))
            xp = torch.as_tensor(rng.standard_normal((g, b, qp, x_dim), np.float32), device=device)
            w_shape = (kf, g, y_dim, x_dim) if flip_t else (kf, g, x_dim, y_dim)
            wf = torch.as_tensor(rng.standard_normal(w_shape, np.float32), device=device)
            wf = wf / (kf * x_dim) ** 0.5
            if dtype == "bf16":
                xp, wf = xp.bfloat16(), wf.bfloat16()
            y = gouter_kernel.gouter_tap_dots_kernel(xp, wf, s, q, flip_t)
            ms = chip_smoke.device_ms(
                torch, lambda: gouter_kernel.gouter_tap_dots_kernel(xp, wf, s, q, flip_t), 5)
            raw = y.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            out["shapes"].append({"key": f"{scale} {layer} {kind}", "shape": shape, "ms": ms,
                                  "sha256": hashlib.sha256(raw).hexdigest()})
    torch.save(out, save)
    total = sum(r["ms"] for r in out["shapes"])
    print(f"{root}: B2 {dtype} over the 30 shapes {total:.4f} ms device time [{card}]")


def compare(a, b):
    import torch

    ra, rb = torch.load(a), torch.load(b)
    differ = 0
    for x, y in zip(ra["shapes"], rb["shapes"]):
        same = x["sha256"] == y["sha256"]
        differ += not same
        print(f"{x['key']} {tuple(x['shape'])}: {'bit-equal' if same else 'DIFFERENT'}; "
              f"{x['ms'] * 1e3:.1f} us / {y['ms'] * 1e3:.1f} us")
    ta, tb = (sum(r["ms"] for r in rr["shapes"]) for rr in (ra, rb))
    print(f"totals: {ra['root']} {ta:.4f} ms, {rb['root']} {tb:.4f} ms ({tb / ta - 1:+.1%}); "
          f"{30 - differ} of 30 shapes bit-equal [{ra['card']}]")
    return 1 if differ else 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=pathlib.Path, default=ROOT)
    parser.add_argument("--save", type=pathlib.Path)
    parser.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    parser.add_argument("--compare", nargs=2, type=pathlib.Path)
    args = parser.parse_args()
    if args.compare:
        return compare(*args.compare)
    import torch

    if not torch.cuda.is_available():
        print("torch_tap_dots_ab: no CUDA device is visible", file=sys.stderr)
        return 1
    if args.save is None:
        parser.error("--save is needed with --root")
    run(args.root.resolve(), args.save, args.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
