"""Verify the ND multifrontal factor SHARDS over the device mesh —
the distributed-MUMPS capability check (reference runs distributed-memory
parallel MUMPS: /root/reference/docs/src/installation.md:13, SURVEY §3.5).

For a virtual N-device mesh this compiles the factor program twice
(mesh=None -> replicated; mesh=make_mesh(N) -> front-batch axis sharded
over 'dof') and records, from the compiled per-device module:
  * XLA cost_analysis() flops  — per-DEVICE flops; sharding should cut
    these ~Nx for the batched dense work,
  * GSPMD collective counts    — the extend-add/solve traffic,
  * numerical parity of factor+solve between the two programs.

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
          python tools/probe_nd_scaling.py --L 6 --out artifacts/scaling_nd_L6_virtual8.json
"""

import argparse
import json
import re
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "collective-permute",
    "reduce-scatter",
    "all-to-all",
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--L", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import importlib
    import multigridbarrier_tpu as mgb
    from multigridbarrier_tpu.backend import make_mesh
    from multigridbarrier_tpu.solver.ndsolve import (
        NDFactorizer,
        NDSymbolic,
        node_coords,
    )

    A = importlib.import_module("multigridbarrier_tpu.solver.amgb")

    ndev = len(jax.devices())
    g = mgb.fem2d(L=args.L)
    spec = A._normalize_D(A.default_D(2))
    dt_ = g.x.dtype
    c0 = jax.vmap(lambda xi: jnp.asarray(A.default_f(2, dt_)(xi), dt_))(g.x)
    ctx = A._SolverCtx(g, spec, A.default_Q(2, 1.0).barrier, c0)
    basis = ctx._bases[ctx.levels - 1]
    m, nf = basis.m, 2
    coords = node_coords(basis.idx, m, np.asarray(g.x), basis.nq)
    sym = NDSymbolic(np.asarray(basis.idx), m, nf, coords, leaf=16)

    # SPD-ish symmetric test values (a shifted diagonal)
    rng = np.random.default_rng(0)
    nuniq = sym.nuniq
    vals = rng.standard_normal((nf, nf, nuniq)) * 0.01
    keys = sym.pair_i_all.astype(np.int64) * (sym.m + 1) + sym.pair_j_all
    tkeys = sym.pair_j_all.astype(np.int64) * (sym.m + 1) + sym.pair_i_all
    perm = np.minimum(np.searchsorted(keys, tkeys), nuniq - 1)
    has_t = keys[perm] == tkeys
    vals_t = np.where(
        has_t[None, None, :], vals.transpose(1, 0, 2)[:, :, perm], vals
    )
    vals = (0.5 * (vals + vals_t)).reshape(-1)
    diag_ids = (
        (np.arange(nf, dtype=np.int64) * (nf + 1))[None, :] * nuniq
        + sym.diag_pid[:, None]
    ).reshape(-1)
    vals[diag_ids] = 4.0
    vals_j = jnp.asarray(vals)
    b = jnp.asarray(rng.standard_normal(sym.N))

    rows = []
    x_ref = None
    counts = [c for c in (2, 4, ndev) if 1 < c <= ndev]
    configs = [("replicated", None)] + [
        (f"sharded_{c}dev", make_mesh(c)) for c in sorted(set(counts))
    ]
    for label, mesh in configs:
        fz = NDFactorizer(sym, use_inv=True, mesh=mesh)
        cst = fz.consts()
        factor_j = jax.jit(lambda v, c: fz.factor(v, c))
        solve_j = jax.jit(lambda f, bb, c: fz.solve(f, bb, c))
        lowered = factor_j.lower(vals_j, cst)
        compiled = lowered.compile()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        txt = compiled.as_text()
        colls = {
            name: len(re.findall(rf"{name}(?:-start)?\(", txt))
            for name in COLLECTIVES
        }
        fac = factor_j(vals_j, cst)
        jax.block_until_ready(fac)
        t0 = time.perf_counter()
        jax.block_until_ready(factor_j(vals_j, cst))
        dt = time.perf_counter() - t0
        x = np.asarray(solve_j(fac, b, cst))
        if x_ref is None:
            x_ref = x
        rel = float(
            np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
        )
        row = dict(
            config=label,
            devices=1 if mesh is None else int(mesh.size),
            per_device_flops=float(cost.get("flops", float("nan"))),
            factor_seconds=round(dt, 4),
            collectives={k: v for k, v in colls.items() if v},
            solve_rel_vs_replicated=rel,
        )
        rows.append(row)
        print(json.dumps(row), flush=True)

    if len(rows) >= 2 and rows[0]["per_device_flops"] > 0:
        ratio = rows[0]["per_device_flops"] / rows[-1]["per_device_flops"]
        print(f"# per-device factor flops ratio (replicated/sharded): "
              f"{ratio:.2f}x (mesh={rows[-1]['devices']} devices)")
    else:
        ratio = None

    if args.out:
        artifact = dict(
            benchmark=f"fem2d L={args.L} ND multifrontal factor sharding",
            platform=jax.devices()[0].platform,
            n_dofs=int(sym.N),
            nd_groups=int(sym.ngroups),
            note=(
                "per_device_flops from XLA cost_analysis of the compiled "
                "SPMD module; sharded config constrains the front-batch "
                "axis over the 'dof' mesh axis (solver/ndsolve.py "
                "_shard_batch) — the distributed-MUMPS equivalence check"
            ),
            flops_ratio_replicated_over_sharded=ratio,
            rows=rows,
        )
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"# wrote {args.out}")


if __name__ == "__main__":
    main()
