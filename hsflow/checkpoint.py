"""Checkpoint / resume of solver state (SURVEY.md §5.4).

The reference has no checkpointing (final image output only, §5.4); the
multi-chip/long-video configs need it. Solver state is tiny and regular:
(u, v, completed sweep count, config hash). The fori_loop is chunked into
`checkpoint_every`-sweep segments so host code regains control to write; a
resumed run re-enters at the recorded sweep and is bitwise-identical to an
uninterrupted one (asserted in tests) because chunked fixed-count Jacobi
sweeps compose exactly.

Multi-host note: each array here is a fully-addressable jax.Array on one
process; for sharded multi-host flows, save per-shard to per-process paths
(`checkpoint_path(path, jax.process_index())` builds one) — shard layout is
pure spatial data-parallelism so resume tolerates a different mesh
(SURVEY.md §5.3).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import jax.numpy as jnp
import numpy as np

from hsflow.config import HSConfig, config_hash as _cfg_hash
from hsflow.solver import Flow, hs_solve


def checkpoint_path(path: str, tag) -> str:
    """Suffix `path` with a per-process tag (multi-host per-shard saves)."""
    root, ext = os.path.splitext(path)
    return f"{root}.{tag}{ext or '.npz'}"


def frames_hash(i1, i2) -> str:
    """Stable short hash of the input frame pair (shape, dtype, content);
    stored in checkpoints so a stale checkpoint from a *different* pair at
    the same path cannot silently warm-start the wrong solve."""
    import hashlib

    m = hashlib.sha256()
    for a in (i1, i2):
        a = np.asarray(a)
        m.update(str((a.shape, str(a.dtype))).encode())
        m.update(np.ascontiguousarray(a).tobytes())
    return m.hexdigest()[:16]


def save_state(
    path: str,
    flow: Flow,
    sweeps_done: int,
    cfg: HSConfig,
    input_hash: str = "",
) -> None:
    """Atomically write solver state as .npz (crash-safe: tmp + rename)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                u=np.asarray(flow.u),
                v=np.asarray(flow.v),
                sweeps_done=np.int64(sweeps_done),
                cfg_hash=np.bytes_(_cfg_hash(cfg).encode()),
                input_hash=np.bytes_(input_hash.encode()),
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str, cfg: Optional[HSConfig] = None, input_hash: str = ""):
    """-> (Flow, sweeps_done). Validates the config hash when cfg is given
    and the input-frames hash when both the checkpoint and caller have one
    (checkpoints written before input hashing existed stay loadable)."""
    with np.load(path) as z:
        if cfg is not None:
            stored = bytes(z["cfg_hash"]).decode()
            if stored != _cfg_hash(cfg):
                raise ValueError(
                    f"checkpoint {path} was written with a different config "
                    f"(hash {stored} != {_cfg_hash(cfg)})"
                )
        if input_hash and "input_hash" in z:
            # Empty hashes (save_state called without one) round-trip through
            # npz as NUL-padded bytes; strip before the emptiness check.
            stored_ih = bytes(z["input_hash"]).decode().strip("\x00 ")
            if stored_ih and stored_ih != input_hash:
                raise ValueError(
                    f"checkpoint {path} was written for a different frame "
                    f"pair (input hash {stored_ih} != {input_hash})"
                )
        return (
            Flow(jnp.asarray(z["u"]), jnp.asarray(z["v"])),
            int(z["sweeps_done"]),
        )


def hs_solve_checkpointed(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: HSConfig,
    path: str,
    resume: bool = True,
) -> Flow:
    """hs_solve with periodic state saves and resume-from-checkpoint.

    cfg.checkpoint_every = K chunks the solve into K-sweep segments; state is
    written after each segment. With resume=True an existing checkpoint at
    `path` restarts from its recorded sweep; the final flow is bitwise equal
    to an uninterrupted cfg.iters-sweep solve.
    """
    k = cfg.checkpoint_every
    if k <= 0:
        raise ValueError("cfg.checkpoint_every must be > 0 for checkpointed solve")
    ih = frames_hash(i1, i2)
    done = 0
    flow: Optional[Flow] = None
    if resume and os.path.exists(path):
        flow, done = load_state(path, cfg, input_hash=ih)
        if done > cfg.iters:
            raise ValueError(
                f"checkpoint {path} records {done} sweeps but cfg.iters is "
                f"{cfg.iters}; refusing to return an over-iterated flow"
            )
    while done < cfg.iters:
        step = min(k, cfg.iters - done)
        seg_cfg = dataclasses.replace(cfg, iters=step)
        flow = hs_solve(i1, i2, seg_cfg, init=flow)
        done += step
        save_state(path, flow, done, cfg, input_hash=ih)
    if flow is None:  # iters == 0
        flow = hs_solve(i1, i2, dataclasses.replace(cfg, iters=0))
    return flow
