"""Objective-value regression against the exact-direct-solve trajectory.

Mid-path barrier Hessians reach cond ~ 1e15; inexact Newton directions
silently drift the iterate off the central path and the solver then
reports convergence at a measurably suboptimal point (measured: MG-CG at
fem2d L=5 lands 1.3e-3 .. 2.0e-3 above the exact-solve objective — see
tools/probe_mult_schwarz.py and the dense_threshold docstring).  These
tests pin the default configuration to exact-solver objectives so any
future linear-solver change that degrades direction quality fails loudly
instead of "converging" to the wrong answer.

Values produced by tools/check_exact.py (dense Cholesky at EVERY level,
the reference's MUMPS trajectory, SURVEY.md §3.5).
"""

import multigridbarrier_tpu as mgb

# exact-solver objectives, fem2d p=1 defaults (tools/check_exact.py for
# L<=5; L=6 is the honest exact-direction CPU trajectory — substitution
# ND factors, CLAUDE.md round-2 session-4/5)
C_EXACT = {
    4: 50.618082533590,
    5: 27.360702531510,
    6: 15.4183231432,
}

# Floor bands: the documented stop-variation band of honest runs at
# scales CI cannot solve (fem2d L=7/L=8 take minutes on an accelerator,
# longer on CPU).  chip_smoke.py holds the GPU's L=7 solve to band 7.
# L=8's band is anchored to the CPU ground truth 6.3963937825 and still
# admits an endgame that stops ~5.6e-5 rel shallow; tighten it to 1e-6
# rel once an accelerator run lands on the truth.
FLOOR_BAND = {
    7: (9.415747, 9.415769),
    8: (6.3963937, 6.39683),
}


def test_fem2d_L4_objective_matches_exact():
    sol = mgb.amgb(mgb.fem2d(L=4), p=1.0)
    c = float(sol.SOL_main.c_dot_Dz[-1])
    assert abs(c - C_EXACT[4]) < 5e-7 * abs(C_EXACT[4])


def test_fem2d_L5_objective_matches_exact():
    # L=5's finest level (nf*m = 1922) must sit on the direct path by
    # default (dense_threshold >= 2048); with it, the whole trajectory is
    # exact-direct and lands on the exact objective.
    sol = mgb.amgb(mgb.fem2d(L=5), p=1.0)
    c = float(sol.SOL_main.c_dot_Dz[-1])
    assert abs(c - C_EXACT[5]) < 5e-7 * abs(C_EXACT[5])


def test_fem2d_L6_objective_matches_exact():
    """The cheapest scale whose FINE level runs the ND multifrontal path
    at default thresholds (L=5 routes dense, CLAUDE.md round-2: any ND
    A/B at L=5 is vacuous).  ~2 min on CPU — the price of pinning the
    production fine-solver trajectory in CI."""
    sol = mgb.amgb(mgb.fem2d(L=6), p=1.0)
    c = float(sol.SOL_main.c_dot_Dz[-1])
    assert abs(c - C_EXACT[6]) < 5e-7 * abs(C_EXACT[6])


def test_chip_smoke_holds_l7_to_its_floor_band():
    """chip_smoke.py (the GPU smoke run) checks the fem2d L=7 objective
    against its own copy of FLOOR_BAND[7]; the two must not drift."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke

    assert chip_smoke.L_MAIN == 7
    assert chip_smoke.BAND == FLOOR_BAND[7]
