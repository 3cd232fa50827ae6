"""Dump per-iteration Newton traces (lam2/alpha/dphi) grouped by t."""

import os
from collections import defaultdict

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import multigridbarrier_tpu as mgb

L = int(os.environ.get("MGB_PARITY_L", "5"))
g = mgb.fem2d(L=L)
s = mgb.amgb(g, p=1.0, mixed=False)
fine = g.levels - 1
by_t = defaultdict(list)
for rec in s.log:
    if rec["level"] == fine and rec["phase"] == "main":
        by_t[rec["t"]].append(rec)
for t, recs in by_t.items():
    lam2s = [r["lam2"] for r in recs]
    alphas = [r["alpha"] for r in recs]
    dphis = [r["dphi"] for r in recs]
    cgits = [r.get("cgits", -1) for r in recs]
    cgrels = [r.get("cgrel", -1.0) for r in recs]
    print(
        f"t={t:.3e} n={len(recs)} cg_total={sum(cgits)} "
        f"cg_max={max(cgits)} cgrel_max={max(cgrels):.2e} "
        f"cgrel_last={cgrels[-1]:.2e}"
    )
    for i in range(0, len(recs), max(1, len(recs) // 10)):
        print(
            f"   k={i:3d} lam2={lam2s[i]:.4e} alpha={alphas[i]:.3f} "
            f"dphi={dphis[i]:.4e} cg={cgits[i]}"
        )
    print(
        f"   last: lam2={lam2s[-1]:.4e} alpha={alphas[-1]:.3f} "
        f"dphi={dphis[-1]:.4e} cg={cgits[-1]}"
    )
print("total fine its:", sum(len(v) for v in by_t.values()))
print("c:", s.SOL_main.c_dot_Dz[-1])
