"""End-to-end demo: synthetic pair -> flow -> .flo + color wheel + needles
-> ego-motion. Runs anywhere (CPU or GPU); writes into ./demo_out/.

    python examples/demo.py [--size 256x384] [--shift 2.0,0.5] [--pyramid]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", default="256x384")
    p.add_argument("--shift", default="2.0,0.5")
    p.add_argument("--pyramid", action="store_true")
    p.add_argument("-o", "--out", default="demo_out")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = p.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax.numpy as jnp

    from hsflow import HSConfig, PyramidConfig, flow_with_occlusion
    from hsflow.data.synthetic import translation_pair
    from hsflow.egomotion import estimate_egomotion
    from hsflow.io.flo import write_flo
    from hsflow.io.images import save_image
    from hsflow.metrics import epe, interior
    from hsflow.viz import flow_to_color, needle_plot

    h, w = (int(t) for t in args.size.split("x"))
    tx, ty = (float(t) for t in args.shift.split(","))
    os.makedirs(args.out, exist_ok=True)

    i1, i2, gt = translation_pair(h, w, tx, ty, key=7)
    save_image(os.path.join(args.out, "frame1.png"), i1)
    save_image(os.path.join(args.out, "frame2.png"), i2)

    t0 = time.perf_counter()
    if args.pyramid or max(abs(tx), abs(ty)) > 2:
        # One batch-2 solve: forward flow + backward leg for the mask.
        flow, occ = flow_with_occlusion(
            jnp.asarray(i1), jnp.asarray(i2),
            HSConfig(alpha=0.1, iters=400), PyramidConfig(levels=3),
        )
    else:
        # Solve-to-tolerance: stop when the max update/block < 1e-4 px
        # instead of guessing an iteration count (iters = budget cap).
        flow, occ = flow_with_occlusion(
            jnp.asarray(i1), jnp.asarray(i2),
            HSConfig(alpha=0.1, iters=2000, tol=1e-4, block_sweeps=50),
        )
    f = np.stack([np.asarray(flow.u), np.asarray(flow.v)], axis=-1)
    dt = time.perf_counter() - t0

    write_flo(os.path.join(args.out, "flow.flo"), f)
    save_image(os.path.join(args.out, "flow_color.png"), flow_to_color(f))
    save_image(os.path.join(args.out, "flow_needles.png"), needle_plot(f, background=i1))

    em = estimate_egomotion(flow)
    print(f"solved {w}x{h} in {dt * 1e3:.0f} ms (incl. compile)")
    print(f"EPE vs analytic GT (interior): {epe(interior(f, 10), interior(gt, 10)):.4f}")
    print(
        f"ego-motion: t=({float(em.tx):+.2f}, {float(em.ty):+.2f}) px "
        f"(true {tx:+.2f}, {ty:+.2f}), residual {float(em.residual):.4f}"
    )

    save_image(os.path.join(args.out, "occlusion.png"),
               np.asarray(occ).astype(np.float32))
    print(f"occlusion mask (fwd-bwd test): {100 * float(occ.mean()):.1f}% "
          f"flagged (periodic synthetic pair -> expect ~0)")
    print(f"outputs in {args.out}/: frame1/2.png flow.flo flow_color.png "
          f"flow_needles.png occlusion.png")


if __name__ == "__main__":
    main()
