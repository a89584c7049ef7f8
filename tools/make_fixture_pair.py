"""Generate the checked-in micro-fixture pair (tests/data/fixture_*).

Round-2 VERDICT item 10: the Middlebury EPE gate auto-skips offline, so a
permanent, un-skippable end-to-end fixture must exercise the full
file-format -> solve -> EPE -> viz path. This script (deterministic, run
once, outputs committed) synthesizes a photographic-statistics texture —
multi-octave smooth value noise, NOT the sinusoid family the synthetic
test generator uses, so the fixture is an independent check — and a second
frame sampled from the SAME continuous texture shifted by (u, v) =
(0.60, -0.35) px, giving analytically exact constant ground-truth flow with
zero resampling error.

Outputs (all tiny, dependency-free formats):
  tests/data/fixture_frame1.png   16-bit grayscale PNG (io/png16 codec path)
  tests/data/fixture_frame2.pgm   binary PGM (the PNM loader path)
  tests/data/fixture_gt.flo       ground-truth flow (.flo path)

Regenerate with: python tools/make_fixture_pair.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from hsflow.io.flo import write_flo
from hsflow.io.images import save_image
from hsflow.io.png16 import write_png

H, W = 48, 64
DU, DV = 0.60, -0.35  # GT flow (x, y) px — sub-pixel on purpose


def texture(xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Multi-octave smooth value noise evaluated at float positions —
    continuous in (x, y), so frame 2 is an EXACT sub-pixel shift. Octave
    lattices are fixed by seed; bilinear blending between lattice points
    (the classic value-noise construction) gives C0 'natural' texture with
    a 1/f-ish spectrum, unlike the test generator's global sinusoids."""
    rng = np.random.default_rng(20260819)
    val = np.zeros_like(xs, dtype=np.float64)
    amp = 1.0
    for octave in range(4):
        cell = 16.0 / (2**octave)  # lattice spacing in px: 16, 8, 4, 2
        n_y = int(np.ceil(H / cell)) + 3
        n_x = int(np.ceil(W / cell)) + 3
        lattice = rng.uniform(-1.0, 1.0, (n_y, n_x))
        gx = xs / cell + 1.0
        gy = ys / cell + 1.0
        x0 = np.floor(gx).astype(int)
        y0 = np.floor(gy).astype(int)
        fx = gx - x0
        fy = gy - y0
        sx = fx * fx * (3 - 2 * fx)  # smoothstep: C1 continuity
        sy = fy * fy * (3 - 2 * fy)
        v00 = lattice[y0, x0]
        v01 = lattice[y0, x0 + 1]
        v10 = lattice[y0 + 1, x0]
        v11 = lattice[y0 + 1, x0 + 1]
        val += amp * ((v00 * (1 - sx) + v01 * sx) * (1 - sy)
                      + (v10 * (1 - sx) + v11 * sx) * sy)
        amp *= 0.55
    lo, hi = val.min(), val.max()
    return ((val - lo) / (hi - lo) * 0.8 + 0.1).astype(np.float32)


def main() -> None:
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tests", "data")
    os.makedirs(out, exist_ok=True)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    i1 = texture(xs, ys)
    # Backward-warp convention (SURVEY.md §2.5 PYR): I2(p) = I1(p - flow),
    # i.e. features MOVE BY +flow from frame 1 to frame 2.
    i2 = texture(xs - DU, ys - DV)
    write_png(os.path.join(out, "fixture_frame1.png"),
              np.round(i1 * 65535).astype(np.uint16))
    save_image(os.path.join(out, "fixture_frame2.pgm"), i2)
    gt = np.empty((H, W, 2), np.float32)
    gt[..., 0] = DU
    gt[..., 1] = DV
    write_flo(os.path.join(out, "fixture_gt.flo"), gt)
    print(f"wrote fixtures to {out} (GT flow = ({DU}, {DV}) px)")


if __name__ == "__main__":
    main()
