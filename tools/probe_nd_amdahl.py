"""Per-depth flop distribution of the ND multifrontal factor — the
Amdahl ceiling for batch-axis (front-parallel) sharding.

The sharded ND factor (solver/ndsolve.py _shard_batch) partitions each
depth's front BATCH over the 'dof' mesh axis.  That parallelism dies at
the tree top: depth d has ~2^d fronts, so the top log2(ndev) depths have
fewer fronts than devices and their (largest, cubically-dominant) dense
work is serial per device.  This probe quantifies exactly that from the
symbolic analysis alone (no numeric factor): per-group front count,
padded front size, Cholesky+inverse flops, and the fraction of total
flops in groups with batch < ndev — the strong-scaling ceiling
1 / (serial + parallel/ndev) reported per device count.

The fix direction it motivates (SCALING.md): within-front sharding of
the top separator fronts (2-D block distribution of the big dense
Cholesky), which is how distributed MUMPS handles its root front.

Run: python tools/probe_nd_amdahl.py --L 7 [--leaf 16] [--out f.json]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--L", type=int, default=7)
    ap.add_argument("--leaf", type=int, default=16)
    ap.add_argument("--nf", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import importlib
    import multigridbarrier_tpu as mgb
    from multigridbarrier_tpu.solver.ndsolve import NDSymbolic, node_coords

    A = importlib.import_module("multigridbarrier_tpu.solver.amgb")

    g = mgb.fem2d(L=args.L)
    spec = A._normalize_D(A.default_D(2))
    dt_ = g.x.dtype
    c0 = jax.vmap(lambda xi: jnp.asarray(A.default_f(2, dt_)(xi), dt_))(g.x)
    ctx = A._SolverCtx(g, spec, A.default_Q(2, 1.0).barrier, c0)
    basis = ctx._bases[ctx.levels - 1]
    m = basis.m
    coords = node_coords(basis.idx, m, np.asarray(g.x), basis.nq)
    sym = NDSymbolic(
        np.asarray(basis.idx), m, args.nf, coords, leaf=args.leaf
    )

    nf = args.nf
    rows = []
    total = 0.0
    for d in range(sym.ngroups):
        ids = np.where(sym.group_of == d)[0]
        nfr = len(ids)
        S = sym.s_pad[d] * nf      # eliminated slots (padded)
        B = sym.b_pad[d] * nf      # border slots (padded)
        F = S + B
        # per-front padded flops: Cholesky of SxS (S^3/3), border triangular
        # solve (S^2*B), Schur update (S*B^2), explicit-inverse formation
        # (~S^3/3 + S^2*B for the use_inv path)
        per_front = (2 / 3) * S**3 + 2 * S * S * B + S * B * B
        fl = nfr * per_front
        total += fl
        rows.append(
            dict(group=d, fronts=int(nfr), S=int(S), B=int(B), F=int(F),
                 gflops=round(fl / 1e9, 4))
        )

    for r in rows:
        r["flop_pct"] = round(100 * r["gflops"] * 1e9 / total, 2)
    print(json.dumps(rows, indent=1))
    print(f"# total padded factor gflops: {total / 1e9:.3f}")

    ceilings = {}
    for ndev in (2, 4, 8, 16, 64):
        # groups with fewer fronts than devices: their work only spreads
        # over `fronts` devices, the rest idle
        t_par = sum(
            r["gflops"] / min(ndev, max(r["fronts"], 1)) for r in rows
        )
        ceilings[ndev] = round((total / 1e9) / t_par, 2)
    print(
        "# batch-axis strong-scaling ceiling (ideal speedup vs 1 device): "
        + ", ".join(f"{k}dev={v}x" for k, v in ceilings.items())
    )

    if args.out:
        with open(args.out, "w") as f:
            json.dump(
                dict(
                    benchmark=f"fem2d L={args.L} ND factor flop distribution",
                    leaf=args.leaf,
                    total_gflops=round(total / 1e9, 3),
                    batch_axis_speedup_ceiling=ceilings,
                    groups=rows,
                ),
                f,
                indent=1,
            )
        print(f"# wrote {args.out}")


if __name__ == "__main__":
    main()
