"""Solver configuration registry — the documented home of every MGB_* knob.

The reference's configuration surface is kwargs-only (tol/maxit/verbose/...,
splatted tolerantly through the entry points — SURVEY.md §5.6,
/root/reference/src/MultiGridBarrierMPI.jl:594-600).  This package keeps that
kwargs surface for everything a *user* of the reference would set, and adds
environment knobs for the engineering underneath (solver-engine selection,
precision policy, dispatch chunking).  This module is the single
registry of those knobs: what they mean, their default, and — critically —
whether they shape the *compiled device programs*.

``SolverOptions.from_env()`` snapshots every program-shaping knob; the
snapshot is part of the ``_get_ctx`` cache key (solver/amgb.py), so flipping
e.g. ``MGB_ND_LEAF`` between two solves on the same geometry builds a fresh
context (new symbolic factorization, new jitted kernels) instead of silently
reusing state compiled for the old value.  Pure-observability knobs are
excluded from the snapshot so toggling logging never recompiles.

Kinds:
  kernel       shapes compiled device programs or solver routing  -> keyed
  host         host-side control logic (refactor caps, orderings) -> keyed
               (cheap to key; wrong reuse would still change results)
  experimental measured-REJECTED A/B machinery kept for reproducibility of
               the negative result (see CLAUDE.md "measured-rejected"
               records); off by default, not production paths     -> keyed
  observe      logging/profiling/caching only                     -> NOT keyed
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import jax


@dataclasses.dataclass(frozen=True)
class Knob:
    kind: str  # kernel | host | experimental | observe
    default: Optional[str]  # None = platform-dependent (PlatformPolicy)
    help: str


@dataclasses.dataclass(frozen=True)
class PlatformPolicy:
    """Defaults of the knobs whose best value depends on the platform.

    One field per knob; an explicit ``MGB_*`` variable always wins.  The
    solver context resolves this once (``platform_policy()``) and reads
    the defaults from it, so no solver module tests the backend itself.
    """

    platform: str
    nd_f32pc: bool  # MGB_ND_F32PC
    nd_cheap: str  # MGB_ND_CHEAP
    nd_inv: bool  # MGB_ND_INV
    nd_chol: str  # MGB_ND_CHOL
    nd_pcg: int  # MGB_ND_PCG


# Native IEEE f64 (CPU LAPACK; cuSOLVER/cuBLAS on an NVIDIA GPU): fresh
# f64 factors every Newton step, substitution-applied, XLA's Cholesky and a
# two-sweep CG polish.  The pair-f32 cheap engine, the f32pc certification
# gate, explicit inverses and the blocked Cholesky were built for hardware
# that emulates f64 in software and stay reachable by their knobs.
_NATIVE_F64 = dict(nd_f32pc=False, nd_cheap="f32", nd_inv=False,
                   nd_chol="xla", nd_pcg=2)
_POLICIES = {
    "cpu": PlatformPolicy(platform="cpu", **_NATIVE_F64),
    "gpu": PlatformPolicy(platform="gpu", **_NATIVE_F64),
}


def platform_policy(platform: Optional[str] = None) -> PlatformPolicy:
    """The platform policy for `platform` (default: JAX's default backend).

    Only ``cpu`` and ``gpu`` are known; any other platform raises rather
    than silently running with defaults tuned for different hardware."""
    if platform is None:
        platform = jax.default_backend()
    try:
        return _POLICIES[platform]
    except KeyError:
        raise RuntimeError(
            f"no solver policy for platform {platform!r} "
            f"(known: {', '.join(sorted(_POLICIES))})"
        ) from None


# Every supported MGB_* variable.  Knobs with default None take their
# default from PlatformPolicy; the registry records what each one means.
KNOBS = {
    # -- solver routing + Newton loop ------------------------------------
    "MGB_FINE_SOLVER": Knob("kernel", "nd",
        "fine-level Newton solver: nd (on-device multifrontal, the "
        "production default everywhere) | host (SuperLU + factor reuse "
        "on the host; kept as the exact-direction A/B reference) | mgcg "
        "(sharded MG-CG fallback; accuracy-limited at depth, see "
        "docs/guide.md)"),
    "MGB_NEWTON_CHUNK": Knob("kernel", "4",
        "Newton steps per device program of the chunked (dense/mgcg) "
        "level loop; one host sync per chunk"),
    "MGB_NEWTON_PATIENCE": Knob("kernel", "0",
        "extra stall iterations tolerated before accepting a floor stop"),
    "MGB_STALL_WIN": Knob("kernel", "2",
        "quadratic-region plateau window W: stall when min(lam2 over "
        "last W) fails to beat 0.95*min(lam2 over the W before); "
        "smaller W accepts the arithmetic floor sooner (W=2 measured "
        "objective-identical at L=5/6, -27% fine its at L=7)"),
    "MGB_LS_ALPHA0": Knob("kernel", "damped",
        "line-search start: damped | full (full measured-rejected: path "
        "drifts, CLAUDE.md round-2 session-4)"),
    # -- ND multifrontal (solver/ndsolve.py) -----------------------------
    "MGB_ND_LEAF": Knob("kernel", "16",
        "nested-dissection leaf size (64/128 pay padded-front f64 "
        "flops)"),
    "MGB_ND_BUCKET": Knob("kernel", "1",
        "split depth groups into front-size classes (1: 2-8x factor "
        "flop cut on CPU; 0: fewer, larger batches)"),
    "MGB_ND_EA": Knob("kernel", "fanin",
        "extend-add engine: fanin (flat segment_sum) | relay (batch/row "
        "gathers + one-hot matmuls)"),
    "MGB_ND_CHOL": Knob("kernel", None,
        "Cholesky engine: xla (LAPACK on CPU, cuSOLVER batched potrf on "
        "GPU) | blocked (right-looking panel matmuls)"),
    "MGB_ND_TRIINV": Knob("kernel", None,
        "triangular-inverse engine: blocked (block doubling) | xla"),
    "MGB_ND_PANEL": Knob("kernel", "32",
        "panel width for the blocked Cholesky / block-doubling inverse "
        "(wider panels: fewer sequential stages, more padded flops)"),
    "MGB_HOST_TMIN": Knob("kernel", "0",
        "barrier parameter t at which ND-routed fine levels hand the "
        "direction solve to the host SuperLU engine (true IEEE f64; "
        "0 = never).  Built for an endgame whose device factor is not "
        "accurate enough at t>=1e6; candidate setting 1e6 pays host "
        "factors only for the last ~30-40 its.  CPU-validated exact "
        "at L=6"),
    "MGB_ND_INV": Knob("kernel", None,
        "1 = apply factors via explicit inverse (batched matmuls); "
        "0 = triangular substitution (backward-stable; on CPU the "
        "inverse costs ~1e-6 objective drift and +10% Newton its at "
        "fem2d L=6)"),
    "MGB_ND_RELAY_COLS": Knob("kernel", "gather",
        "relay column selection: gather | onehot"),
    "MGB_ND_SPLITSUM": Knob("kernel", None,
        "split the combined per-depth segment_sum into per-source sums"),
    "MGB_ND_EA_ROWMB": Knob("kernel", "4",
        "relay extend-add scatter window cap in MB: whole-front "
        "segment_sum below, row-level segments above (bounds the "
        "scatter's working set; the fem2d L=8 root front is a 7.8MB "
        "f64 window, the largest at L=7 3.91MB); 0 forces rows "
        "everywhere"),
    "MGB_ND_PCG": Knob("kernel", None,
        "CG-polish sweeps after each ND solve (0 pairs with explicit-"
        "inverse factors — polish cannot beat the inverse floor)"),
    "MGB_ND_PCG32": Knob("kernel", "0",
        "run the polish sweeps in f32"),
    # -- f32-preconditioned certified directions ---------------------------
    "MGB_ND_F32PC": Knob("kernel", None,
        "1 = equilibrated+shifted f32 multifrontal factor preconditions "
        "f64 PCG on the exact Hessian, certified at cg_rtol (pays where "
        "an f64 factor costs many times an f32 one; 0 with native f64)"),
    "MGB_ND_F32_SHIFT": Knob("kernel", "3e-6",
        "diagonal shift applied INSIDE the f32 preconditioner only (the "
        "Newton direction itself is never shifted)"),
    "MGB_ND_F32_MM_PREC": Knob("kernel", "highest",
        "matmul precision for f32 factor traces (a default-precision f32 "
        "dot may run in TF32, ~10 mantissa bits, on a GPU; 'highest' = "
        "true f32, required for the preconditioner to certify past "
        "t~10)"),
    "MGB_ND_KRYLOV32": Knob("kernel", "0",
        "1 = stage-1 f32 Krylov warm start inside f32pc directions: run "
        "the early PCG contraction entirely in the equilibrated f32 "
        "frame (f32 matvec/preconditioner/vector ops) down to "
        "MGB_ND_KRYLOV32_TOL, then warm-start the f64 PCG that owns the "
        "certification gate — the accepted direction is exactly as "
        "converged, only the route to it is cheaper where f64 vector "
        "ops cost many times f32 ones"),
    "MGB_ND_KRYLOV32_TOL": Knob("kernel", "1e-4",
        "stage-1 relative-residual target for MGB_ND_KRYLOV32 (a stall "
        "window exits doomed stage-1 loops where the f32 floor sits "
        "above this)"),
    "MGB_ND_F32PC_COOLDOWN": Knob("host", "8",
        "Newton its between f32pc retries after a failed certification"),
    "MGB_ND_FUSED_GATE": Knob("kernel", "1",
        "1 = the f32pc certification gate runs ON DEVICE inside one "
        "fused per-iteration program (post+pre+attempt+lax.cond f64 "
        "fallback) — saves cross-program fusion and the serialized "
        "gate RTT; 0 = split host-gated programs (_run_level_nd_reuse)"),
    "MGB_ND_PIPELINE": Knob("host", "0",
        "pipelined dispatch in the fused-gate runner: dispatch Newton "
        "iteration k+1 on iteration k's output futures before blocking "
        "on k's scalar get, hiding a host round-trip under device "
        "execution.  Speculated "
        "attempt flags steer device performance only (directions stay "
        "certified-or-fresh-f64 by the on-device gate); a conservative "
        "stop predictor avoids wasting programs at stage ends, and a "
        "mispredicted speculation is discarded, never applied.  No "
        "program changes.  NOT bit-"
        "reproducible vs the sync path: a speculated step uses a "
        "one-step-stale attempt cap, so a certification can flip "
        "between certified-f32pc and fresh-f64 — both gated, valid "
        "directions, but the Newton paths (and iteration counts) may "
        "differ slightly."),
    "MGB_ND_STALE_CAP": Knob("host", None,
        "max PCG its against a stale factor before refactoring"),
    "MGB_ND_STALE_GATE": Knob("experimental", "0",
        "endgame stale-factor engine of the fused-gate runner: once the "
        "f32 engine retires, PCG preconditioned by the last f64 factor, "
        "certified at the fresh factor's own measured residual floor "
        "(max(cg_rtol, margin*rel_fresh)).  Measured-REJECTED (round 3, "
        "fem2d L=4/6/7 CPU heartbeat + accelerator bench): the endgame is the "
        "DAMPED region (alpha 0.02-0.3), each accepted step moves the "
        "barrier margins multiplicatively, and a 1-step-stale factor "
        "preconditions so poorly that attempts reach only 1e-2..1 rel "
        "vs gates of 1e-9..1e-7 — every attempt fails.  This "
        "is WHY the reference refactors (MUMPS) every Newton step."),
    "MGB_ND_STALE_MARGIN": Knob("host", "1.5",
        "stale-engine gate margin over the fresh factor's measured "
        "achieved relative residual"),
    "MGB_ND_STALE_PCG_CAP": Knob("host", "16",
        "max PCG its per stale-engine attempt (adaptive below this)"),
    "MGB_ND_REUSE_CAP": Knob("host", None,
        "adaptive cap on certified-reuse attempts per factor"),
    # -- host SuperLU path (solver/hostsolve.py) -------------------------
    "MGB_HOST_ORDERING": Knob("host", None,
        "SuperLU ordering override (default SymmetricMode MMD_AT_PLUS_A "
        "+ diag_pivot_thresh=0: flat 2.8s factors where COLAMD+pivoting "
        "blew up to 7-10s mid-path)"),
    "MGB_HOST_STALE_CAP": Knob("host", "40",
        "max preconditioned-CG its against a stale LU before refactoring"),
    # -- MG-CG scale-out fallback (solver/linsolve.py) -------------------
    "MGB_SMOOTHER": Knob("kernel", None,
        "MG smoother: schwarz | jacobi"),
    "MGB_SCHWARZ_LIFT": Knob("kernel", "3e-3",
        "absolute lift on Schwarz block diagonals (3e-2 locks the path, "
        "1e-4 mistargets Chebyshev — CLAUDE.md round-2)"),
    "MGB_CHEB_RATIO": Knob("kernel", "8.0",
        "Chebyshev window ratio lmax/lmin (64/512 measured shallower)"),
    "MGB_MG_DEPTH": Knob("kernel", None, "MG cycle depth"),
    "MGB_MG_DEGREE": Knob("kernel", "3",
        "Chebyshev smoothing degree per V-cycle leg.  Raising it is "
        "measured-REJECTED as a two-grid accuracy dial (fem2d L=6, "
        "T=2 deep budget: degree 8 -> rel 3.1e-4 and an early lock at "
        "95 its vs degree 3's 9.8e-6 at 281 its): higher degree "
        "amplifies Chebyshev window mistargeting on barrier spectra "
        "instead of strengthening the cycle.  3 stays"),
    "MGB_MGCG_LEVELS": Knob("kernel", "auto",
        "truncate the V-cycle hierarchy to the top T levels (T >= 2) "
        "with an EXACT dense f64 Cholesky at the new coarsest level; "
        "T=2 is the two-grid cycle that removes every mid-level "
        "smoother (the measured depth-ceiling culprit — broad spectrum "
        "spread, not outliers).  auto = two-grid when the coarse dense "
        "factor fits MGB_MGCG_COARSE_CAP; 0 = full hierarchy.  "
        "Measured (round 4): two-grid + the deep budget reaches rel "
        "4.5e-8 at fem2d L=5 (vs the 4.7e-5 full-hierarchy ceiling)"),
    "MGB_MGCG_COARSE_CAP": Knob("kernel", "4096",
        "max nf*(m+1) of the truncated cycle's coarse level (the dense "
        "f64 coarse factor is O(cap^2) memory, O(cap^3) flops per "
        "Newton step); bigger coarse levels keep the full hierarchy — "
        "ND-factored coarse solve is the documented growth path"),
    "MGB_CG_MAXITER_DEEP": Knob("kernel", "1000",
        "CG iteration cap when the truncated (exact-coarse) cycle is "
        "active: the budget that lets CG capture the final 1e-5..1e-8 "
        "of the Newton decrement (wired to truncation — only a cycle "
        "strong enough to use the budget gets it)"),
    "MGB_CYCLE_DTYPE": Knob("kernel", None,
        "V-cycle dtype (f32 preconditioner inside f64 CG)"),
    "MGB_SCALED_PRECOND": Knob("kernel", None,
        "symmetric Jacobi pre-scaling before the f32 cast (required: "
        "unscaled casts go indefinite at cond >~1e7)"),
    "MGB_CG_RTOL": Knob("kernel", None,
        "CG forcing term (keep tight ~1e-9: loose directions point into "
        "the cone boundary and collapse the line search)"),
    "MGB_CG_MAXITER": Knob("kernel", None, "CG iteration cap"),
    "MGB_CG_QEPS": Knob("kernel", None,
        "quadratic-model progress epsilon (MG-CG progress is measured by "
        "the captured Newton decrement, never residual-norm tracking)"),
    "MGB_CG_FLOOR_CAP": Knob("kernel", None,
        "cap on CG its once the decrement floor is reached"),
    "MGB_CG_WARMSTART": Knob("kernel", None, "warm-start CG from prev dz"),
    "MGB_CG_DEFLATE": Knob("experimental", "0",
        "Ritz-deflated MG-CG restart: harvest the preconditioned Lanczos "
        "process from the first CG phase, deflate the k extreme Ritz "
        "vectors (Vuik/Nicolaides projection) and restart.  "
        "Measured-REJECTED as a depth fix (fem2d L=6, new stall "
        "defaults): no-deflation c 15.41922, top-only-8 15.41945, "
        "6small/2large 15.41963 vs exact 15.4183231 — the ~6e-5 ceiling "
        "is not an outlier-eigenvalue problem reachable from inside the "
        "Krylov space (suspect: the f32 V-cycle noise floor at endgame "
        "cond).  Projection exactness stays pinned by "
        "test_mgcg_deflated_restart_matches_dense."),
    "MGB_CG_HARVEST": Knob("kernel", "40",
        "CG iterations in the Lanczos-harvest phase before the deflated "
        "restart"),
    "MGB_CG_DEFLATE_LO": Knob("kernel", "0",
        "how many of the k deflated Ritz pairs come from the SMALL end "
        "of the spectrum (default 0: top-only — half-converged small "
        "Ritz vectors measured-SHALLOWER, see linsolve.mgcg_solve)"),
    # -- precision / early path ------------------------------------------
    "MGB_F32_EARLY": Knob("kernel", None,
        "f32 path-following for t <= MGB_T_SWITCH with f64 endgame"),
    "MGB_T_SWITCH": Knob("kernel", None, "f32->f64 switch barrier value"),
    # -- pair-f32 (double-float) factor kernels ---------------------------
    "MGB_ND_BASE": Knob("kernel", "xla",
        "f64 ND-factor base-block engine: xla (f64 chol/substitution) "
        "or df (pair-f32 double-float, ~2^-44, for hardware without "
        "fast f64).  Production f64 factors keep xla; df is the "
        "cheap-direction engine's factor"),
    "MGB_ND_CHEAP": Knob("kernel", None,
        "cheap-direction engine in the fused gate: f32 (shifted-f32 "
        "factor + certified PCG) or df (pair-f32-base f64 factor, "
        "certifies with ~0 sweeps through t~1e5 per the qbits probe)"),
    "MGB_ND_DF_SHIFT": Knob("kernel", "0",
        "diagonal shift for the df cheap engine's equilibrated factor. "
        "0 (default): certifies with ~0 sweeps wherever finite "
        "(t <= ~1e5) and NaNs instantly beyond — the cheapest failure. "
        "1e-13 stays finite to t~1e7 but needs 12-17 f64 PCG sweeps "
        "there (more than the f64 factor it replaces) — "
        "measured-rejected as a default, kept as the deep-coverage dial"),
    "MGB_ND_SHARD_WIDE": Knob("kernel", "1",
        "within-front row sharding of replicated top-tree groups on a "
        "mesh (the 2-D root-front distribution role of MUMPS): L=6 "
        "8-dev per-device factor flops 1.83x -> 3.96x vs replicated, "
        "solve parity 3e-17 (SCALING.md §3)"),
    "MGB_ND_WIDE_MIN": Knob("kernel", "128",
        "minimum front width (dofs incl. boundary) for within-front "
        "sharding; smaller fronts pay more in resharding than they "
        "distribute"),
    # -- misc kernels ------------------------------------------------------
    "MGB_LANE_AOP": Knob("kernel", None, "lane layout for A-op tables"),
    "MGB_NO_NATIVE": Knob("kernel", "0",
        "disable the C++ geometry kernels (pure-NumPy fallback)"),
    # -- measured-REJECTED machinery (negative-result reproducibility) ---
    "MGB_ND_F32_TMAX": Knob("experimental", "0",
        "direct-f32 factorization below this t — REJECTED: leaf "
        "separators are f32-singular even at t=1e3; kept as the "
        "control arm of the f32pc experiment"),
    "MGB_ND_LAZY": Knob("experimental", "0",
        "split post/pre programs to skip the wasted last factor — "
        "REJECTED on CPU (XLA loses cross-phase fusion, +95ms/it); "
        "accelerator A/B flag (requires MGB_ND_F32PC=0)"),
    "MGB_ND_REUSE": Knob("experimental", "0",
        "stale-factor certified reuse — measured break-even on CPU; "
        "1 always selects the stale-f64 leg (overrides MGB_ND_F32PC)"),
    "MGB_PREDICT": Knob("experimental", "0",
        "Richardson path extrapolation — REJECTED: wedges low-weight "
        "quadrature rows onto the cone boundary, locks levels early"),
    "MGB_PREDICT_DEBUG": Knob("experimental", "0", "predictor tracing"),
    # -- observability / environment (never keyed) ------------------------
    "MGB_HOST_STATS": Knob("observe", "0",
        "per-level factor/solve/loop-phase timing prints"),
    "MGB_ND_HEARTBEAT": Knob("observe", "0",
        "per-group factor heartbeat prints"),
    "MGB_ND_SHARD_ONLY": Knob("observe", None,
        "comma list of group ids to shard (mesh-debug bisection knob)"),
    "MGB_ND_DEBUG_FRONTS": Knob("observe", "0",
        "return raw assembled fronts instead of factors (debug)"),
    "MGB_WARMUP_THREADS": Knob("observe", None,
        "thread count for parallel level warm-up compiles"),
    "MGB_SERIAL_WARMUP": Knob("observe", "0",
        "1 = compile the level kernels one after another"),
}

# Debug knobs that DO change program semantics despite being observe-kind
# (they exist only for bisection sessions; key them so a forgotten export
# can never leak a debug program into a cached production context).
_KEYED_OBSERVE = ("MGB_ND_SHARD_ONLY", "MGB_ND_DEBUG_FRONTS")


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Immutable snapshot of every program-shaping MGB_* knob.

    Hashable — used directly in the ``_get_ctx`` cache key.  Unknown
    ``MGB_*`` variables (not in the registry) are included conservatively:
    an over-keyed cache costs one redundant context build; an under-keyed
    one silently reuses kernels compiled for different semantics (the
    round-2 stale-factorizer bug, VERDICT weak item 3).
    """

    snapshot: Tuple[Tuple[str, str], ...]

    @classmethod
    def from_env(cls) -> "SolverOptions":
        items = []
        for name, val in os.environ.items():
            if not name.startswith("MGB_"):
                continue
            knob = KNOBS.get(name)
            if knob is not None and knob.kind == "observe" and \
                    name not in _KEYED_OBSERVE:
                continue
            if name.startswith(("MGB_BENCH_", "MGB_DRYRUN_")):
                continue  # harness plumbing, never read by solver kernels
            items.append((name, val))
        return cls(snapshot=tuple(sorted(items)))

    def get(self, name: str) -> Optional[str]:
        for k, v in self.snapshot:
            if k == name:
                return v
        knob = KNOBS.get(name)
        return knob.default if knob is not None else None
