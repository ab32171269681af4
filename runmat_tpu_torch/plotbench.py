"""The colormap kernel and imfilter on the card: the fields they are held
to their plain versions on, and their times beside their bounds.

    python3 runmat_tpu_torch/plotbench.py [--tree DIR]

`field(case, shape, dtype)` makes the test fields from a seed (torch's
generator on the given device): a normal field, one with NaNs, one with
+-Inf, a constant one and an all-NaN one. `held(dev)` runs the colormap
kernel against `ops/cmap.py:plain_cmap` on the card, bit for bit, over
every case in float64 and float32 at 1080 x 1920 and 2160 x 3840 and every
colormap of `plot/colors.py`. `cmap_row(a)` times the kernel (and its
range pass alone), the plain version and `torch.aminmax` on the same field
(the yardstick of its reduction: no PyTorch call computes the colormap)
beside its bound: one read of the field and one write of the image over
3.35 TB/s. `imfilter_row(x, k)` times the imfilter builder (`F.pad` and
cuDNN's conv2d) beside its bound: the field read and the result written,
or 2 k_h k_w operations a value over the float64 rate, whichever is
larger. `--tree DIR` runs another checkout's package (for an A/B, in
turns in one call). The CPU tests use `field` to make their inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CASES = ("normal", "nan", "inf", "constant", "all_nan")
# every colormap plot/colors.py defines
COLORMAPS = ("parula", "jet", "gray", "hot", "cool", "spring", "summer",
             "autumn", "winter", "bone", "copper")
SHAPES = ((1080, 1920), (2160, 3840))
REPS = 50


def field(case: str, shape: tuple, dtype, seed: int = 0, device="cpu"):
    """A test field of `case` (CASES) as a tensor on `device`."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    if case == "constant":
        return torch.full(shape, 2.5, dtype=dtype, device=device)
    if case == "all_nan":
        return torch.full(shape, float("nan"), dtype=dtype, device=device)
    a = torch.randn(shape, generator=g, dtype=dtype, device=device) * 3 + 1
    flat = a.view(-1)
    if case == "nan":
        flat[::7] = float("nan")
    elif case == "inf":
        flat[::11] = float("inf")
        flat[5::13] = float("-inf")
    return a


def held(device) -> int:
    """The kernel against plain_cmap on `device` (a card), bit for bit, in
    every case, type, shape and colormap; raises AssertionError on the
    first difference. Returns the number of fields compared."""
    import torch

    from runmat_tpu_torch.ops import cmap
    count = 0
    for shape in SHAPES:
        for dtype in (torch.float64, torch.float32):
            for case in CASES:
                a = field(case, shape, dtype, seed=count, device=device)
                maps = COLORMAPS if case == "normal" else ("parula",)
                for name in maps:
                    rgb, sc = cmap.cmap(a, name)
                    want, wsc = cmap.plain_cmap(
                        a, cmap.device_table(name, a.device))
                    assert torch.equal(rgb, want), \
                        (shape, dtype, case, name, "image")
                    assert torch.equal(sc.isnan(), wsc.isnan()) and \
                        torch.equal(sc.nan_to_num(), wsc.nan_to_num()), \
                        (shape, dtype, case, name, sc.tolist(), wsc.tolist())
                    count += 1
                del a
    torch.cuda.synchronize()
    return count


def cmap_row(a, name: str = "parula") -> dict:
    """The kernel's time on field `a` (a card tensor) beside its bound, its
    range pass alone, the plain version and torch.aminmax."""
    from runmat_tpu_torch import histbench, sass
    from runmat_tpu_torch.ops import cmap
    import torch
    lut = cmap.device_table(name, a.device)
    rgb, sc = cmap.cmap(a, name)
    want, wsc = cmap.plain_cmap(a, lut)
    err = int((rgb.int() - want.int()).abs().max())
    ms = histbench.time_ms(lambda: cmap.cmap(a, name), REPS)
    range_ms = histbench.time_ms(lambda: cmap.cmap(a, name, upto=1), REPS)
    plain_ms = histbench.time_ms(lambda: cmap.plain_cmap(a, lut), 5)
    lib_ms = histbench.time_ms(lambda: torch.aminmax(a), REPS)
    bound, by = sass.bound(a.numel() * a.element_size() + 3 * a.numel())
    return {"shape": list(a.shape), "dtype": str(a.dtype).split(".")[-1],
            "ms": ms, "range_ms": range_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
            "share": bound / ms, "max_abs_err": err}


def imfilter_row(x, k, boundary: str = "replicate") -> dict:
    """The imfilter builder's time on field x with kernel k (card tensors)
    beside its bound."""
    from runmat_tpu_torch import histbench, linalgbench
    from runmat_tpu_torch.accel.dense import _b_imfilter
    f = _b_imfilter(None, (boundary,))
    ms = histbench.time_ms(lambda: f(x, k), REPS)
    nbytes = 2 * x.numel() * x.element_size() + k.numel() * k.element_size()
    flops = 2 * k.numel() * x.numel()
    bound, by = linalgbench.bound(nbytes, flops,
                                  str(x.dtype).split(".")[-1])
    return {"shape": list(x.shape), "kernel": list(k.shape), "ms": ms,
            "bound_ms": bound, "bound_by": by, "share": bound / ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    # the tree replaces this file's directory, whose module names
    # (profile.py, ...) would shadow the standard library's
    sys.path[0] = os.path.abspath(args.tree)
    import torch
    if not torch.cuda.is_available():
        print("plotbench: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, os.path.abspath(args.tree))
    dev = torch.device("cuda")
    print(f"held: {held(dev)} fields bit-equal to plain_cmap")
    for shape in SHAPES:
        for dtype in (torch.float64, torch.float32):
            print(json.dumps(cmap_row(field("normal", shape, dtype,
                                            device=dev))))
    x = field("normal", SHAPES[0], torch.float64, device=dev)
    ax = torch.arange(15, dtype=torch.float64, device=dev) - 7
    k = torch.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / 18)
    print(json.dumps(imfilter_row(x, k / k.sum())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
