"""Micro-benchmark: H@v layout variants on real fem2d Newton systems.

The MG-CG preconditioner applies ~15 H@v products per CG iteration; at a
per-kernel latency floor the op count and layout of hvp IS the solver
runtime.  This tool times the candidate
layouts on the real device so layout decisions are measured, not guessed:

  field : (nf, m+1) coefficients, He (nelem, C, C), C = f*nl + a (round-1
          layout; gathers/scatters need transposes)
  node  : (m+1, nf) coefficients, He (nelem, C, C), C = a*nf + f
          (transpose-free gather -> einsum -> segment_sum)
  lane  : He stored (C, C, nelem) so the element axis sits in VPU lanes;
          contraction is C^2 fused multiply-adds over nelem-long vectors

Usage: python tools/bench_hvp.py [--L 7] [--iters 50] [--dtype f32]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def timeit(fn, *args, iters=5):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)  # compile
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--L", type=int, default=7)
    ap.add_argument("--reps", type=int, default=50, help="hvps per kernel")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import importlib

    import multigridbarrier_tpu as mgb

    A = importlib.import_module("multigridbarrier_tpu.solver.amgb")
    from multigridbarrier_tpu.solver.linsolve import LevelSystem, hvp, diag_of

    print(f"# devices: {jax.devices()}", file=sys.stderr)
    g = mgb.fem2d(L=args.L)
    dtype = g.x.dtype
    spec = A._normalize_D(A.default_D(g.dim))
    Q = A.default_Q(g.dim, 1.0)
    ffun, gfun = A.default_f(g.dim, dtype), A.default_g(g.dim, dtype)
    c = jax.vmap(lambda xi: jnp.asarray(ffun(xi), dtype=dtype))(g.x)
    z = jax.vmap(lambda xi: jnp.asarray(gfun(xi), dtype=dtype))(g.x)
    ctx = A._SolverCtx(g, spec, Q.barrier, c)
    lvl = ctx.levels - 1
    basis = ctx._bases[lvl]
    nf, k = spec.nfields, spec.k
    nelem, nq, nl, m = basis.nelem, basis.nq, basis.nl, basis.m

    # one real Newton-system assembly at t=0.1
    y = A._apply_D(ctx.ops, spec, z)
    F2 = jax.hessian(Q.barrier, argnums=1)
    Y2w = jax.vmap(F2)(ctx.x, y) * ctx.w[:, None, None]
    Y2w_e = Y2w.reshape(nelem, nq, k, k)
    He = A._assemble_He(ctx._P[lvl], Y2w_e)
    print(
        f"# L={args.L} nelem={nelem} nq={nq} nl={nl} m={m} C={nf*nl} "
        f"dtype={He.dtype}",
        file=sys.stderr,
    )

    results = {}
    for dt_name, dt in (("f32", jnp.float32), ("f64", jnp.float64)):
        He_d = He.astype(dt)
        sys_ = LevelSystem(He_d, basis.idx, m, basis.scatter_idx)
        vp_f = jnp.ones((nf, m + 1), dtype=dt).at[:, m].set(0.0)

        # --- field-major (current) ---
        def run_field(He_d, vp, reps=args.reps):
            s = LevelSystem(He_d, basis.idx, m)

            def body(_, v):
                w = hvp(s, v)
                return w * (1.0 / (1.0 + 1e-30))

            return jax.lax.fori_loop(0, reps, body, vp)

        t = timeit(jax.jit(run_field), He_d, vp_f, iters=args.iters)
        results[f"hvp_field_{dt_name}"] = t / args.reps

        # --- node-major ---
        idx = basis.idx
        vp_n = jnp.ones((m + 1, nf), dtype=dt).at[m].set(0.0)

        def hvp_node(He_d, vp):
            ve = vp[idx].reshape(nelem, nf * nl)
            hve = jnp.einsum("eab,eb->ea", He_d, ve)
            out = jax.ops.segment_sum(
                hve.reshape(-1, nf), idx.reshape(-1), num_segments=m + 1
            )
            return out.at[m].set(0.0)

        def run_node(He_d, vp, reps=args.reps):
            def body(_, v):
                return hvp_node(He_d, v) * (1.0 / (1.0 + 1e-30))

            return jax.lax.fori_loop(0, reps, body, vp)

        t = timeit(jax.jit(run_node), He_d, vp_n, iters=args.iters)
        results[f"hvp_node_{dt_name}"] = t / args.reps

        # --- lane-major: He (C, C, nelem), element axis in lanes ---
        He_l = jnp.array(He_d.transpose(1, 2, 0))

        def hvp_lane(He_l, vp):
            ve = vp[idx].reshape(nelem, nf * nl).T  # (C, nelem)
            hve = jnp.einsum("abe,be->ae", He_l, ve)  # VPU FMAs over e
            out = jax.ops.segment_sum(
                hve.T.reshape(-1, nf), idx.reshape(-1), num_segments=m + 1
            )
            return out.at[m].set(0.0)

        def run_lane(He_l, vp, reps=args.reps):
            def body(_, v):
                return hvp_lane(He_l, v) * (1.0 / (1.0 + 1e-30))

            return jax.lax.fori_loop(0, reps, body, vp)

        t = timeit(jax.jit(run_lane), He_l, vp_n, iters=args.iters)
        results[f"hvp_lane_{dt_name}"] = t / args.reps

        # --- segment_sum vs gather-table dual on the hvp scatter ---
        def run_table(He_d, vp, reps=args.reps):
            s = LevelSystem(He_d, basis.idx, m, basis.scatter_idx)

            def node_sum_table(flat):
                padded = jnp.concatenate(
                    [flat, jnp.zeros((1, nf), dtype=flat.dtype)], axis=0
                )
                return jnp.sum(padded[basis.scatter_idx], axis=1)

            def body(_, v):
                ve = v[idx].reshape(nelem, nf * nl)
                hve = jnp.einsum("eab,eb->ea", He_d, ve)
                out = node_sum_table(hve.reshape(-1, nf))
                return out.at[m].set(0.0)

            return jax.lax.fori_loop(0, reps, body, vp)

        t = timeit(jax.jit(run_table), He_d, vp_n, iters=args.iters)
        results[f"hvp_node_table_{dt_name}"] = t / args.reps

    for k_, v in results.items():
        print(f"{k_}: {v*1e3:.3f} ms")


if __name__ == "__main__":
    main()
