"""Validate factorization reuse across Newton steps (self-concordance).

Theory: barrier Hessians at nearby path points are spectrally equivalent
(self-concordance), so CG on H_k preconditioned by chol(H_j) for j < k
has cond ~ O(1) INCLUDING the 1e-15 soft tail (both matrices share it) —
unlike any smoother-based preconditioner, which cannot resolve the tail
at all (tools/probe_mult_schwarz.py).

This probe replays the fem2d path at small L with exact dense solves via
the `linear_solver` hook, capturing every fine-level (H, b); afterwards
it measures, for each captured step, f64 PCG iterations to 1e-9 with the
factor of an earlier step's H as preconditioner.  Reported per distance
j-k and across t boundaries — the data that sets the refactor policy for
the big-level direct solver.

Env: MGB_PROBE_L (default 4).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import scipy.linalg as sla

import multigridbarrier_tpu as mgb

L = int(os.environ.get("MGB_PROBE_L", "4"))

captured = []  # list of (H, b) dense f64


def _record(H, b):
    captured.append((np.asarray(H, np.float64), np.asarray(b, np.float64)))


def capture_solver(H, b):
    # the hook runs under jit: ship concrete values out via debug.callback.
    # Mirrors dense_solve's unshifted-first + shift-escalation ladder
    # (solver/linsolve.py) — without it the path fails near t ~ 1e6 when a
    # negative pivot NaNs the factorization.
    import jax
    import jax.numpy as jnp
    import jax.scipy.linalg as jsla

    jax.debug.callback(_record, H, b)
    eps = float(jnp.finfo(b.dtype).eps)
    ii = jnp.arange(H.shape[0])

    def attempt(shift):
        Hs = H.at[ii, ii].mul(1.0 + shift) if shift else H
        cf = jsla.cho_factor(Hs)
        x = jsla.cho_solve(cf, b)
        for _ in range(2):
            x = x + jsla.cho_solve(cf, b - H @ x)
        return x

    x = attempt(0.0)
    for s in (500 * eps, 50000 * eps):
        x = jax.lax.cond(
            jnp.all(jnp.isfinite(x)), lambda x: x, lambda _: attempt(s), x
        )
    return x


g = mgb.fem2d(L=L)
sol = mgb.amgb(g, p=1.0, linear_solver=capture_solver)
print(
    f"L={L}: captured {len(captured)} fine systems; "
    f"c={float(sol.SOL_main.c_dot_Dz[-1]):.12e} its={sol.SOL_main.its.tolist()}"
)

# the hook fires at every level; keep only the finest (largest N)
N = max(H.shape[0] for H, _ in captured)
captured = [(H, b) for H, b in captured if H.shape[0] == N]
print(f"fine-level systems: {len(captured)} of size {N}")


def pcg_its(H, b, cf, maxiter=120, tol=1e-9):
    x = np.zeros(N)
    r = b.copy()
    z = sla.cho_solve(cf, r)
    p = z.copy()
    rz = r @ z
    b2 = b @ b
    for it in range(maxiter):
        if r @ r <= tol * tol * b2:
            return it
        Ap = H @ p
        pAp = p @ Ap
        if pAp <= 0 or rz <= 0:
            return -(it + 1)  # breakdown marker
        al = rz / pAp
        x += al * p
        r -= al * Ap
        z = sla.cho_solve(cf, r)
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
    return maxiter


# stale-factor CG cost vs staleness distance
ks = list(range(0, len(captured)))
print("step  cond_est   its(d=1) its(d=2) its(d=4) its(d=8)")
for k in range(1, len(captured)):
    H, b = captured[k]
    row = []
    for d in (1, 2, 4, 8):
        j = k - d
        if j < 0:
            row.append(None)
            continue
        try:
            cf = sla.cho_factor(captured[j][0])
        except Exception:
            row.append("chol-fail")
            continue
        row.append(pcg_its(H, b, cf))
    dd = np.abs(np.diag(H))
    print(
        f"{k:4d}  {dd.max()/max(dd.min(),1e-300):9.2e}  "
        + " ".join(f"{r!s:>8}" for r in row)
    )
