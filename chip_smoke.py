#!/usr/bin/env python3
"""hsflow on one NVIDIA GPU: every deployment's main path, checked.

    python chip_smoke.py           # one card: c1-c4, the solver families,
                                   # the GPU-marked tests and `hsflow selftest`
    python chip_smoke.py --multi   # four cards: the c5 tiled 4K path only

Each phase prints one line and compares against the repo's own reference
with a stated tolerance; any failure raises and fails the run. Times printed
here are smoke timings (warm, median of chained calls), not the benchmark.
The last stdout line is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Without a GPU, or without the hsflow package beside this script, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Fields are O(1) and the sweep has no reduction or matrix product, so two
# implementations differ only by FMA contraction inside a contractive
# iteration: they agree to ~1e-6, far inside this bound.
TOL_SOLVE = 1e-5
# The pyramid adds bilinear resampling (HIGHEST-precision interpolation
# products) and warps whose sample positions inherit flow differences, so
# differences grow per level.
TOL_PYRAMID = 1e-4
# Tiled vs untiled solve: identical arithmetic per pixel, halos exchanged
# exactly.
TOL_TILED = 5e-6
# Tiled vs untiled pyramid: the sharded program fuses the per-level
# resampling (upsample, warp) differently, so the warped frames differ by
# ~1 ulp, which 100 sweeps at alpha=1 on each of three levels amplify
# (measured 6.1e-6 at 2160x3840 on a 4x1 mesh of H200s; 1e-6 at 264x384 on
# four CPU devices). Flows are O(1) px.
TOL_TILED_PYRAMID = 2e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def warm_ms(fn, *args, chain: int = 10, reps: int = 5) -> float:
    """Median ms per call over `reps` chains of `chain` calls, after a
    compiling call; every chain ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(chain):
            r = fn(*args)
        jax.block_until_ready(r)
        out.append((time.perf_counter() - t0) / chain * 1e3)
    return statistics.median(out)


def maxdiff(a, b) -> float:
    import numpy as np

    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def check(name: str, ok: bool, detail: str) -> None:
    if not ok:
        raise AssertionError(f"{name}: {detail}")


class Phase:
    def __init__(self, name: str):
        self.name = name
        self.notes: list[str] = []

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def note(self, s: str) -> None:
        self.notes.append(s)

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            log(f"[phase {self.name}] ok in {time.perf_counter() - self.t0:.1f}s: "
                + "; ".join(self.notes))
        return False  # never swallow


def flow_epe(flow, gt, margin: int) -> float:
    import numpy as np

    from hsflow.metrics import epe, interior

    f = np.stack([np.asarray(flow.u), np.asarray(flow.v)], -1)
    return float(epe(interior(f, margin), interior(gt, margin)))


def peak_gib(dev) -> str:
    stats = dev.memory_stats() or {}
    return f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB"


# -- one card -----------------------------------------------------------------


def phase_c1(dev):
    import jax
    import jax.numpy as jnp

    from hsflow import HSConfig, hs_solve
    from hsflow.data.synthetic import translation_pair
    from hsflow.ops.golden import hs_numpy

    with Phase("c1 hs_solve 1080x1920") as p:
        i1, i2, gt = translation_pair(1080, 1920, 1.0, 0.5, key=3)
        a, b = jnp.asarray(i1), jnp.asarray(i2)
        gu, gv = hs_numpy(i1, i2, alpha=1.0, iters=100)
        flows, times = {}, {}
        for backend in ("jnp", "pallas"):
            cfg = HSConfig(alpha=1.0, iters=100, backend=backend)
            fn = jax.jit(lambda x, y, cfg=cfg: hs_solve(x, y, cfg))
            flows[backend] = fn(a, b)
            times[backend] = warm_ms(fn, a, b)
            d = max(maxdiff(flows[backend].u, gu), maxdiff(flows[backend].v, gv))
            check(f"{backend} vs golden", d <= TOL_SOLVE, f"max|d| {d:.2e}")
            p.note(f"{backend} vs golden max|d| {d:.2e} <= {TOL_SOLVE:g}")
        d = max(maxdiff(flows["pallas"].u, flows["jnp"].u),
                maxdiff(flows["pallas"].v, flows["jnp"].v))
        check("kernel vs jnp", d <= TOL_SOLVE, f"max|d| {d:.2e}")
        p.note(f"kernel vs jnp max|d| {d:.2e}")
        f = hs_solve(a, b, HSConfig(alpha=0.1, iters=1500))
        e = flow_epe(f, gt, 10)
        check("EPE a=0.1 i1500", e < 0.05, f"EPE {e:.4f}")
        p.note(f"EPE(a=0.1, i1500, auto) {e:.4f} < 0.05")
        p.note("warm ms/solve i100: " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items()))
        p.note(f"peak {peak_gib(dev)}")


def phase_c3():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from hsflow import HSConfig, PyramidConfig, hs_pyramid
    from hsflow.data.synthetic import translation_pair
    from hsflow.pyramid import upsample_flow
    from hsflow.solver import Flow

    with Phase("c3 hs_pyramid levels=3, 4 px shift") as p:
        i1, i2, gt = translation_pair(1080, 1920, 4.0, 0.0, key=4)
        a, b = jnp.asarray(i1), jnp.asarray(i2)
        pyr = PyramidConfig(levels=3)
        out = {}
        for backend in ("jnp", "pallas"):
            cfg = HSConfig(alpha=0.1, iters=200, backend=backend)
            out[backend] = hs_pyramid(a, b, cfg, pyr)
            e = flow_epe(out[backend], gt, 16)
            check(f"{backend} pyramid EPE", e < 0.1, f"EPE {e:.4f}")
            p.note(f"{backend} EPE {e:.4f} < 0.1")
        d = max(maxdiff(out["pallas"].u, out["jnp"].u),
                maxdiff(out["pallas"].v, out["jnp"].v))
        check("pyramid backends", d <= TOL_PYRAMID, f"max|d| {d:.2e}")
        p.note(f"kernel vs jnp max|d| {d:.2e} <= {TOL_PYRAMID:g}")
        z = jnp.zeros((540, 960), jnp.float32)
        hlo = jax.jit(lambda f: upsample_flow(f, (1080, 1920))).lower(
            Flow(z, z)).as_text()
        dots = [ln for ln in hlo.splitlines() if "dot_general" in ln]
        check("upsample precision", all("HIGHEST" in ln for ln in dots),
              f"{len(dots)} dot_general, not all HIGHEST")
        p.note(f"upsample_flow: {len(dots)} dot_general, all "
               f"{lax.Precision.HIGHEST.name}")


def phase_c2():
    import jax.numpy as jnp

    from hsflow import HSConfig, hs_solve
    from hsflow.batch import hs_solve_batched
    from hsflow.data.synthetic import synthetic_sequence

    with Phase("c2 hs_solve_batched B=4 1080p") as p:
        frames, _ = synthetic_sequence(5, 1080, 1920, key=2)
        f = jnp.asarray(frames)
        cfg = HSConfig(alpha=1.0, iters=100)
        fb = hs_solve_batched(f[:-1], f[1:], cfg)
        d = 0.0
        for k in range(4):
            s = hs_solve(f[k], f[k + 1], cfg)
            d = max(d, maxdiff(fb.u[k], s.u), maxdiff(fb.v[k], s.v))
        check("batched vs per-frame", d <= TOL_SOLVE, f"max|d| {d:.2e}")
        p.note(f"batched vs per-frame max|d| {d:.2e} <= {TOL_SOLVE:g}")


def phase_c4():
    import numpy as np

    from hsflow.cli import main as cli_main
    from hsflow.config import load_config
    from hsflow.data.synthetic import synthetic_sequence
    from hsflow.io.flo import read_flo
    from hsflow.io.images import save_image
    from hsflow.video import flow_stream_warm

    with Phase("c4 hsflow video --warm, 8 PGM frames 1080p") as p, \
            tempfile.TemporaryDirectory() as td:
        frames, _ = synthetic_sequence(8, 1080, 1920, key=5)
        src = os.path.join(td, "frames")
        os.makedirs(src)
        for k, fr in enumerate(frames):
            save_image(os.path.join(src, f"f{k:03d}.pgm"), fr)
        out = os.path.join(td, "out")
        preset = os.path.join(ROOT, "configs", "c4_hd_streaming.json")
        cli_main(["--config", preset, "video", src, "-o", out, "--warm"])  # compile
        t0 = time.perf_counter()
        rc = cli_main(["--config", preset, "video", src, "-o", out, "--warm"])
        dt = time.perf_counter() - t0
        check("cli rc", rc == 0, f"rc {rc}")
        # the CLI reads the PGMs back at 8 bits; compare on the same frames
        from hsflow.io.images import load_gray

        stored = np.stack([load_gray(os.path.join(src, f"f{k:03d}.pgm"))
                           for k in range(8)])
        ref = list(flow_stream_warm(stored, load_config(preset).hs))
        d = 0.0
        for k, fl in enumerate(ref):
            got = read_flo(os.path.join(out, f"flow_{k:05d}.flo"))
            d = max(d, maxdiff(got[..., 0], fl.u), maxdiff(got[..., 1], fl.v))
        check(".flo vs flow_stream_warm", d == 0.0, f"max|d| {d:.2e}")
        p.note(f"{len(ref)} .flo == in-memory flow_stream_warm (max|d| {d:g})")
        p.note(f"smoke (not a benchmark): {7 / dt:.1f} frame pairs/s incl. "
               "PGM decode and .flo writes")


def phase_families():
    import jax.numpy as jnp
    import numpy as np

    from hsflow import HSConfig, hs_solve
    from hsflow.config import LKConfig, PyramidConfig, TVL1Config
    from hsflow.consistency import flow_with_occlusion
    from hsflow.data.synthetic import translation_pair, two_motion_pair
    from hsflow.egomotion import estimate_egomotion
    from hsflow.lucas_kanade import lk_solve
    from hsflow.tvl1 import tvl1_solve

    i1, i2, gt = translation_pair(1080, 1920, 1.0, 0.0, key=3)
    a, b = jnp.asarray(i1), jnp.asarray(i2)

    with Phase("sor auto-omega") as p:
        e = flow_epe(hs_solve(a, b, HSConfig(alpha=0.1, iters=100,
                                             solver="sor", omega=0.0)), gt, 8)
        check("sor EPE", e < 0.1, f"EPE {e:.4f}")
        p.note(f"EPE {e:.4f} < 0.1")

    with Phase("multigrid") as p:
        def run(solver, iters):
            return flow_epe(hs_solve(a, b, HSConfig(alpha=1.0, iters=iters,
                                                    solver=solver)), gt, 8)
        e_mg, e_j1600, e_j100 = run("multigrid", 2), run("jacobi", 1600), \
            run("jacobi", 100)
        check("mg vs jacobi-1600", e_mg <= 1.1 * e_j1600, f"{e_mg} {e_j1600}")
        check("mg vs jacobi-100", 20 * e_mg <= e_j100, f"{e_mg} {e_j100}")
        p.note(f"2 V-cycles EPE {e_mg:.4f} <= 1.1 x Jacobi-1600 {e_j1600:.4f}"
               f", x20 <= Jacobi-100 {e_j100:.4f}")

    with Phase("robust two_motion_pair") as p:
        s1, s2, sgt = two_motion_pair(1080, 1920, (1.0, 0.0), (-1.0, 0.0),
                                      key=3)
        s1, s2 = jnp.asarray(s1), jnp.asarray(s2)
        ec = flow_epe(hs_solve(s1, s2, HSConfig(alpha=0.1, iters=400)), sgt, 8)
        er = flow_epe(hs_solve(s1, s2, HSConfig(alpha=0.1, iters=400,
                                                solver="robust")), sgt, 8)
        check("robust vs classic", er < 0.75 * ec, f"{er} {ec}")
        p.note(f"robust EPE {er:.4f} < 0.75 x classic {ec:.4f}")

    with Phase("lucas-kanade") as p:
        l1, l2, lgt = translation_pair(1080, 1920, 0.7, -0.4, key=3)
        e = flow_epe(lk_solve(jnp.asarray(l1), jnp.asarray(l2),
                              LKConfig(iters=3)), lgt, 12)
        check("lk EPE", e < 0.08, f"EPE {e:.4f}")
        p.note(f"EPE {e:.4f} < 0.08")

    with Phase("tv-l1") as p:
        e = flow_epe(tvl1_solve(a, b, TVL1Config()), gt, 8)
        check("tvl1 EPE", e < 0.08, f"EPE {e:.4f}")
        p.note(f"EPE {e:.4f} < 0.08")

    with Phase("flow_with_occlusion + estimate_egomotion") as p:
        flow, occ = flow_with_occlusion(a, b, HSConfig(alpha=0.1, iters=300),
                                        PyramidConfig(levels=1))
        occ_in = float(np.asarray(occ)[8:-8, 8:-8].mean())
        check("occlusion", occ_in < 0.05, f"interior occluded {occ_in}")
        em = estimate_egomotion(flow)
        check("egomotion", abs(float(em.tx) - 1.0) < 0.2, f"tx {em.tx}")
        p.note(f"interior occluded {occ_in:.4f} < 0.05; ego tx "
               f"{float(em.tx):+.3f} (truth +1)")


def phase_gpu_tests():
    import pytest

    from hsflow.cli import main as cli_main

    with Phase("pytest -m gpu, hsflow selftest") as p:
        os.environ["HSFLOW_TEST_GPU"] = "1"
        tests = os.path.join(ROOT, "tests")
        files = sorted(
            os.path.join(d, f) for d, _, fs in os.walk(tests) for f in fs
            if f.startswith("test_") and f.endswith(".py")
            and "mark.gpu" in open(os.path.join(d, f)).read()
        )
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:xdist",
                          "-p", "no:cacheprovider", "-p", "no:randomly",
                          "--rootdir", ROOT, *files])
        check("pytest -m gpu", rc == 0, f"exit {rc}")
        rc = cli_main(["selftest"])
        check("selftest", rc == 0, f"exit {rc}")
        p.note("gpu-marked tests passed; selftest passed")


# -- four cards ---------------------------------------------------------------


def phase_multi():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hsflow import HSConfig, PyramidConfig, hs_pyramid, hs_solve
    from hsflow.config import MeshConfig
    from hsflow.data.synthetic import translation_pair
    from hsflow.dist import hs_pyramid_tiled, hs_solve_tiled, make_mesh
    from hsflow.egomotion import estimate_egomotion
    from hsflow.solver import Flow

    n = len(jax.devices())
    check("device count", n == 4, f"{n} devices; --multi needs 4")
    i1, i2, _ = translation_pair(2160, 3840, 1.0, 0.5, key=6)
    dev0 = jax.devices()[0]
    a = jax.device_put(jnp.asarray(i1), dev0)
    b = jax.device_put(jnp.asarray(i2), dev0)
    cfg = HSConfig(alpha=1.0, iters=100)
    pyr = PyramidConfig(levels=3)
    ref_s = hs_solve(a, b, cfg)
    ref_p = hs_pyramid(a, b, cfg, pyr)
    ms1 = warm_ms(lambda x, y: hs_pyramid(x, y, cfg, pyr), a, b, chain=5)
    em_ref = estimate_egomotion(ref_p)
    log(f"[phase c5 reference] 1 card hs_pyramid 2160x3840: {ms1:.3f} ms/frame")
    for my, mx in ((4, 1), (2, 2)):
        mesh = make_mesh(MeshConfig(batch=1, y=my, x=mx))
        with Phase(f"c5 mesh {my}x{mx}") as p:
            fs = hs_solve_tiled(a, b, cfg, mesh=mesh, halo_sweeps=4)
            d = max(maxdiff(fs.u, ref_s.u), maxdiff(fs.v, ref_s.v))
            check("hs_solve_tiled", d <= TOL_TILED, f"max|d| {d:.2e}")
            p.note(f"hs_solve_tiled vs untiled max|d| {d:.2e} <= "
                   f"{TOL_TILED:g}")
            fp = hs_pyramid_tiled(a, b, cfg, pyr, mesh=mesh, halo_sweeps=4)
            d = max(maxdiff(fp.u, ref_p.u), maxdiff(fp.v, ref_p.v))
            check("hs_pyramid_tiled", d <= TOL_TILED_PYRAMID,
                  f"max|d| {d:.2e}")
            p.note(f"hs_pyramid_tiled vs untiled max|d| {d:.2e} <= "
                   f"{TOL_TILED_PYRAMID:g}")
            ms4 = warm_ms(lambda x, y: hs_pyramid_tiled(
                x, y, cfg, pyr, mesh=mesh, halo_sweeps=4), a, b, chain=5)
            p.note(f"{ms4:.3f} ms/frame on 4 cards vs {ms1:.3f} on 1")
            # sharded ego-motion: moments psum-reduced over ("y", "x")
            sh = NamedSharding(mesh, P("y", "x"))
            u, v = jax.device_put(ref_p.u, sh), jax.device_put(ref_p.v, sh)
            th, tw = 2160 // my, 3840 // mx

            def fit(ut, vt):
                off = (jax.lax.axis_index("y") * th,
                       jax.lax.axis_index("x") * tw)
                em = estimate_egomotion(Flow(ut, vt), axis_names=("y", "x"),
                                        global_offset=off)
                return jnp.stack([em.tx, em.ty, em.omega, em.scale,
                                  em.residual])

            got = jax.jit(jax.shard_map(fit, mesh=mesh,
                                        in_specs=(P("y", "x"), P("y", "x")),
                                        out_specs=P()))(u, v)
            want = jnp.stack([em_ref.tx, em_ref.ty, em_ref.omega,
                              em_ref.scale, em_ref.residual])
            d = maxdiff(got, want)
            check("sharded egomotion", d <= 1e-5, f"max|d| {d:.2e}")
            p.note(f"sharded ego-motion fit vs global max|d| {d:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the c5 four-card path and its reference")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs}", file=sys.stderr)
        return 2
    import hsflow  # noqa: F401  (fails here when the script stands alone)
    from hsflow.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"devices: {devs}")
    log(f"nvidia-smi: {smi}")
    log(f"compile cache: {cache}")
    t0 = time.perf_counter()
    if args.multi:
        phase_multi()
    else:
        phase_c1(devs[0])
        phase_c3()
        phase_c2()
        phase_c4()
        phase_families()
        phase_gpu_tests()
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
