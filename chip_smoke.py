"""Smoke test of the fem2d f64 barrier solve on an NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # four cards: the mesh path and its 1-card twin

One card:
  0. Device: JAX's default device must be a GPU (anything else exits
     non-zero at once); prints its kind and count and the nvidia-smi card
     name and power limit, which every number below belongs to.
  1. Kernels against references at real widths:
     a. the ND multifrontal factor + solve, with the platform's default
        engines, of a real barrier Hessian of the fem2d L=6 fine level,
        against a scipy sparse direct solve in f64 on the host;
     b. the pair-f32 base kernels (_df_chol, _df_tri_inv) against f64
        Cholesky / triangular solves at widths 16, 32 and the widest
        diagonal block of the L=7 factor (a TF32 dot or a compiler
        rewrite of the error-free transforms drops them to f32 accuracy).
  2. Main path: mgb.fem2d(L=7) and mgb.amgb(p=1) twice (a warm-up solve
     that pays compilation, then a timed solve); the objective must lie in
     the CPU-truth band FLOOR_BAND[7] (tests/test_ground_truth.py).

--four runs only fem2d L=7 on backend_mesh(n_devices=4) (within-front
sharding at its default) and the 1-card solve of the same problem: both
objectives in FLOOR_BAND[7] and within tol*1000 of each other (the
reference's distributed-vs-native contract), per-device peak memory
balanced.

The last stdout line is the JSON result; any failure exits non-zero before
printing it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

import multigridbarrier_tpu as mgb  # noqa: E402  (fails outside the repo)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multigridbarrier_tpu.solver.amgb import (  # noqa: E402
    _SolverCtx,
    _normalize_D,
    default_D,
    default_f,
    default_g,
    default_Q,
)
from multigridbarrier_tpu.solver.ndsolve import (  # noqa: E402
    NDFactorizer,
    NDSymbolic,
    _df_chol,
    _df_tri_inv,
    node_coords,
)

# The main path's problem: fem2d L=7 p=1 at tol=sqrt(eps), the reference's
# benchmark row, and its CPU-truth objective band (FLOOR_BAND[7] in
# tests/test_ground_truth.py)
L_MAIN = 7
BAND = (9.415747, 9.415769)

# Tolerances and why:
# - ND solve: relative residual of the Jacobi-equilibrated system
#   D^-1/2 A D^-1/2.  Cholesky is backward stable, so an f64 multifrontal
#   solve leaves ~1e-14; 1e-10 keeps four orders of margin while a TF32
#   (~1e-3) or f32 (~1e-7) leak anywhere in the factor fails by orders.
#   The difference to scipy's solution (same equilibrated norm) is bounded
#   by cond * residual and is held to 1e-8.
ND_RES_TOL = 1e-10
ND_DIFF_TOL = 1e-8
# - df kernels: pair-f32 keeps ~2^-44 (tests/test_dfmm.py); errors grow
#   with the width n, so the bounds are EPS_DF * n (Cholesky factor,
#   relative Frobenius) and 4 * EPS_DF * n (||X L - I|| of the inverse).
EPS_DF = 2.0 ** -44


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of every visible card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def peak_bytes(device) -> int:
    return device.memory_stats()["peak_bytes_in_use"]


def fine_level_ctx(g):
    """Solver context of the p=1 problem on geometry g, and the initial
    iterate z0."""
    dtype = g.x.dtype
    spec = _normalize_D(default_D(g.dim))
    Q = default_Q(g.dim, 1.0)
    ffun, gfun = default_f(g.dim, dtype), default_g(g.dim, dtype)
    c = jax.vmap(lambda xi: jnp.asarray(ffun(xi), dtype=dtype))(g.x)
    z0 = jax.vmap(lambda xi: jnp.asarray(gfun(xi), dtype=dtype))(g.x)
    return _SolverCtx(g, spec, Q.barrier, c), z0


def phase_nd(L: int = 6) -> None:
    """ND factor + solve of a real barrier Hessian against scipy."""
    import scipy.sparse.linalg as spla

    ctx, z0 = fine_level_ctx(mgb.fem2d(L=L))
    level = ctx.levels - 1
    basis = ctx._bases[level]
    pat = ctx._get_host_pattern(level)
    h = ctx._get_host(level)
    dtype = ctx.x.dtype
    vals, gv, *_ = h["pre"](
        ctx._P[level], basis, ctx.x, ctx.w, ctx.c, z0,
        jnp.asarray(1.0, dtype), h["full_ids"],
    )
    vals = np.asarray(vals, np.float64)
    m, nf = pat.m, pat.nf
    sym = NDSymbolic(
        np.asarray(basis.idx), m, nf,
        node_coords(basis.idx, m, np.asarray(ctx.x), basis.nq),
        leaf=int(os.environ.get("MGB_ND_LEAF", "16")),
    )
    fz = NDFactorizer(sym)
    cst = fz.consts()
    factor = jax.jit(lambda v, c: fz.factor(v, c))
    solve = jax.jit(lambda f, b, c: fz.solve(f, b, c))
    b_fm = np.array(gv, np.float64).reshape(nf, m + 1)
    b_fm[:, m] = 0.0
    b_nd = b_fm[:, :m].T.reshape(-1)  # node-major, as ndsolve orders dofs
    t0 = time.perf_counter()
    x_nd = np.asarray(solve(factor(jnp.asarray(vals), cst),
                            jnp.asarray(b_nd), cst))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_nd = np.asarray(solve(factor(jnp.asarray(vals), cst),
                            jnp.asarray(b_nd), cst))
    t_warm = time.perf_counter() - t0

    Hs = pat.fill(vals)  # field-major, identity on the pad dofs
    x_ref = spla.splu(Hs.tocsc()).solve(b_fm.reshape(-1))
    x_fm = np.zeros((nf, m + 1))
    x_fm[:, :m] = x_nd.reshape(m, nf).T
    s = 1.0 / np.sqrt(np.abs(Hs.diagonal()))  # Jacobi equilibration
    res = np.linalg.norm(s * (Hs @ x_fm.reshape(-1) - b_fm.reshape(-1))) / \
        np.linalg.norm(s * b_fm.reshape(-1))
    diff = np.linalg.norm((x_fm.reshape(-1) - x_ref) / s) / \
        np.linalg.norm(x_ref / s)
    ok = bool(np.isfinite(x_nd).all() and res <= ND_RES_TOL
              and diff <= ND_DIFF_TOL)
    log(f"phase1a nd L={L} N={sym.N} groups={sym.ngroups} "
        f"chol={fz.chol} inv={int(fz.use_inv)} ea={fz.ea_mode} "
        f"first={t_first:.3f}s warm={t_warm:.4f}s "
        f"eq_residual={res:.3e} (<= {ND_RES_TOL:g}) "
        f"diff_vs_scipy={diff:.3e} (<= {ND_DIFF_TOL:g}) "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 1a failed: ND solve disagrees with scipy")


def widest_block(g) -> int:
    """Widest diagonal block (separator dofs) of geometry g's fine-level
    ND factor: what _df_chol / _df_tri_inv see with MGB_ND_CHOL=xla."""
    basis = g.bases["dirichlet"][-1]
    nf = _normalize_D(default_D(g.dim)).nfields
    sym = NDSymbolic(
        np.asarray(basis.idx), basis.m, nf,
        node_coords(basis.idx, basis.m, np.asarray(g.x), basis.nq),
        leaf=int(os.environ.get("MGB_ND_LEAF", "16")),
    )
    return nf * int(max(sym.s_pad))  # s_pad counts nodes; blocks are dofs


def phase_df(widths) -> None:
    """Pair-f32 base kernels against f64 references.  A TF32 dot or a
    compiler rewrite of the error-free transforms drops them to f32
    accuracy (~1e-8), four orders above their bounds."""
    rng = np.random.default_rng(0)
    chol = jax.jit(_df_chol, static_argnums=1)
    tinv = jax.jit(_df_tri_inv, static_argnums=1)
    failed = []
    for n in widths:
        n_d = max(2, 4096 // n)
        B = rng.standard_normal((n_d, n, n))
        Am = B @ np.swapaxes(B, -1, -2) + n * np.eye(n)[None]
        Am_d = jnp.asarray(Am)
        L_ref = jnp.linalg.cholesky(Am_d)
        Lc = chol(Am_d, n)
        rel_c = float(jnp.max(
            jnp.linalg.norm(Lc - L_ref, axis=(1, 2))
            / jnp.linalg.norm(L_ref, axis=(1, 2))
        ))
        eye = jnp.broadcast_to(jnp.eye(n), (n_d, n, n))
        X_ref = jax.scipy.linalg.solve_triangular(L_ref, eye, lower=True)
        X = tinv(L_ref, n)
        res_i = float(jnp.max(jnp.linalg.norm(X @ L_ref - eye, axis=(1, 2))))
        rel_i = float(jnp.max(
            jnp.linalg.norm(X - X_ref, axis=(1, 2))
            / jnp.linalg.norm(X_ref, axis=(1, 2))
        ))
        ok = rel_c <= EPS_DF * n and res_i <= 4 * EPS_DF * n
        log(f"phase1b df n={n} batch={n_d}: chol rel={rel_c:.3e} "
            f"(<= {EPS_DF * n:.2e}) tri_inv ||XL-I||={res_i:.3e} "
            f"(<= {4 * EPS_DF * n:.2e}) vs solve_triangular rel={rel_i:.3e} "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            failed.append(n)
    if failed:
        raise SystemExit(f"phase 1b failed at widths {failed}")


def build_geometry(backend, label: str):
    """fem2d L_MAIN geometry on `backend`, timed."""
    t0 = time.perf_counter()
    g = mgb.fem2d(L=L_MAIN, backend=backend)
    log(f"{label} geometry L={L_MAIN} n={g.n} built in "
        f"{time.perf_counter() - t0:.2f}s")
    return g


def timed_solve(g, label: str):
    t0 = time.perf_counter()
    sol = mgb.amgb(g, p=1.0)
    jax.block_until_ready(sol.z)
    dt = time.perf_counter() - t0
    c = float(sol.SOL_main.c_dot_Dz[-1])
    plats = sorted({d.platform for d in sol.z.devices()})
    log(f"{label} {dt:.3f}s its={sol.SOL_main.its.tolist()} "
        f"c_dot_Dz={c:.10f} z on {plats} x{len(sol.z.devices())}")
    return sol, c, dt


def in_band(c: float) -> bool:
    return BAND[0] <= c <= BAND[1]


def phase_main(g) -> None:
    _, c_w, _ = timed_solve(g, "phase2 warm-up solve")
    sol, c, _ = timed_solve(g, "phase2 warm solve")
    peak = peak_bytes(jax.devices()[0])
    log(f"phase2 peak_bytes_in_use={peak} ({peak / 2**30:.2f} GiB)")
    plats = {d.platform for d in sol.z.devices()}
    ok = in_band(c) and in_band(c_w) and plats == {"gpu"}
    log(f"phase2 objective {c:.10f} in {BAND}: "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 2 failed: objective out of band or not on GPU")


def run_four() -> None:
    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devs)}")
    g4 = build_geometry(mgb.backend_mesh(n_devices=4), "four mesh(4)")
    _, c4, _ = timed_solve(g4, "four mesh(4) solve (compile included)")
    peaks = [peak_bytes(d) for d in devs[:4]]
    log("four per-device peak_bytes_in_use after the mesh solve: "
        + " ".join(f"{d.id}:{p}" for d, p in zip(devs, peaks)))
    g1 = build_geometry(mgb.backend_cpu(), "four 1-card")
    _, c1, _ = timed_solve(g1, "four 1-card solve (compile included)")
    tol = float(np.sqrt(np.finfo(np.float64).eps))
    diff = abs(c4 - c1)
    balanced = min(peaks) >= 0.25 * max(peaks)
    ok = in_band(c4) and in_band(c1) and diff <= tol * 1000 and balanced
    log(f"four |c_mesh - c_1card|={diff:.3e} (<= tol*1000={tol * 1000:.3e}) "
        f"bands {in_band(c4)}/{in_band(c1)} balanced={balanced} "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("four-card check failed")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh path and its 1-card twin")
    args = ap.parse_args()

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX's default device is {devs[0].platform}",
              file=sys.stderr)
        return 2
    log(f"device platform=gpu kind={devs[0].device_kind} count={len(devs)}")
    log(card_line())  # nvidia-smi's own "name, power.limit" line(s)
    t0 = time.perf_counter()
    if args.four:
        run_four()
    else:
        phase_nd(6)
        g7 = build_geometry(mgb.backend_cpu(), "phase2")
        phase_df([16, 32, widest_block(g7)])
        phase_main(g7)
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
