"""SolverOptions registry: every program-shaping env knob participates in
the _get_ctx cache key (VERDICT r2 weak item 3 — flipping MGB_ND_LEAF
between solves on one geometry must NOT silently reuse the old
factorizer's kernels)."""

import os

import pytest

import multigridbarrier_tpu as mgb
from multigridbarrier_tpu.options import KNOBS, SolverOptions, platform_policy


def test_snapshot_excludes_observability():
    os.environ["MGB_HOST_STATS"] = "1"
    os.environ["MGB_ND_LEAF"] = "8"
    try:
        snap = SolverOptions.from_env()
        names = [k for k, _ in snap.snapshot]
        assert "MGB_HOST_STATS" not in names
        assert "MGB_ND_LEAF" in names
        assert snap.get("MGB_ND_LEAF") == "8"
    finally:
        del os.environ["MGB_HOST_STATS"], os.environ["MGB_ND_LEAF"]


def test_snapshot_includes_unknown_mgb_vars():
    os.environ["MGB_SOME_FUTURE_KNOB"] = "x"
    try:
        names = [k for k, _ in SolverOptions.from_env().snapshot]
        assert "MGB_SOME_FUTURE_KNOB" in names
    finally:
        del os.environ["MGB_SOME_FUTURE_KNOB"]


def test_registry_defaults_returned_when_unset():
    assert SolverOptions.from_env().get("MGB_SCHWARZ_LIFT") == "3e-3"


def test_every_solver_env_read_is_registered():
    """grep the solver/runtime sources for MGB_ reads; each must be in
    KNOBS (the registry is the documentation of record)."""
    import re
    import pathlib

    pkg = pathlib.Path(mgb.__file__).parent
    seen = set()
    for p in pkg.rglob("*.py"):
        seen |= set(re.findall(r"MGB_[A-Z0-9_]+", p.read_text()))
    # harness plumbing read outside solver kernels
    allowed_unregistered = {
        "MGB_", "MGB_BENCH_L", "MGB_BENCH_DTYPE", "MGB_DRYRUN_SUBPROCESS",
    }
    # prefix literals like "MGB_BENCH_" (startswith filters) aren't knobs
    seen = {s for s in seen if not s.endswith("_")}
    missing = seen - set(KNOBS) - allowed_unregistered
    assert not missing, f"unregistered MGB_ knobs: {sorted(missing)}"


def test_ctx_cache_keyed_on_kernel_knobs():
    g = mgb.fem2d(L=2)
    import importlib

    A = importlib.import_module("multigridbarrier_tpu.solver.amgb")

    spec = A._normalize_D(A.default_D(2))
    Q = A.default_Q(2, 1.0)
    import jax
    import jax.numpy as jnp

    c = jax.vmap(
        lambda xi: jnp.asarray(A.default_f(2, g.x.dtype)(xi), g.x.dtype)
    )(g.x)
    ctx1 = A._get_ctx(g, spec, Q.barrier, c)
    os.environ["MGB_ND_LEAF"] = "8"
    try:
        ctx2 = A._get_ctx(g, spec, Q.barrier, c)
        ctx3 = A._get_ctx(g, spec, Q.barrier, c)
    finally:
        del os.environ["MGB_ND_LEAF"]
    ctx4 = A._get_ctx(g, spec, Q.barrier, c)
    assert ctx2 is not ctx1, "kernel-knob flip must rebuild the context"
    assert ctx3 is ctx2, "same knobs must hit the cache"
    assert ctx4 is ctx1, "restoring knobs must restore the old context"


def test_observability_knob_does_not_rebuild_ctx():
    g = mgb.fem2d(L=2)
    import importlib

    A = importlib.import_module("multigridbarrier_tpu.solver.amgb")

    spec = A._normalize_D(A.default_D(2))
    Q = A.default_Q(2, 1.0)
    import jax
    import jax.numpy as jnp

    c = jax.vmap(
        lambda xi: jnp.asarray(A.default_f(2, g.x.dtype)(xi), g.x.dtype)
    )(g.x)
    ctx1 = A._get_ctx(g, spec, Q.barrier, c)
    os.environ["MGB_HOST_STATS"] = "1"
    try:
        ctx2 = A._get_ctx(g, spec, Q.barrier, c)
    finally:
        del os.environ["MGB_HOST_STATS"]
    assert ctx2 is ctx1


def test_platform_policy_cpu_is_native_f64():
    pol = platform_policy()
    assert pol.platform == "cpu"
    assert (pol.nd_f32pc, pol.nd_cheap, pol.nd_inv, pol.nd_chol,
            pol.nd_pcg) == (False, "f32", False, "xla", 2)


def test_platform_policy_gpu(monkeypatch):
    """A GPU gets the native-f64 engines, and the ND factorizer and the
    solver context read their defaults from that one policy."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    for k in ("MGB_ND_INV", "MGB_ND_CHOL", "MGB_ND_F32PC", "MGB_ND_CHEAP"):
        monkeypatch.delenv(k, raising=False)
    pol = platform_policy()
    assert pol.platform == "gpu"
    assert (pol.nd_f32pc, pol.nd_cheap, pol.nd_inv, pol.nd_chol,
            pol.nd_pcg) == (False, "f32", False, "xla", 2)
    from multigridbarrier_tpu.solver.ndsolve import NDFactorizer, NDSymbolic
    from test_ndsolve import _grid_problem

    idx, coords, _, _ = _grid_problem(6, 2, True)
    fz = NDFactorizer(NDSymbolic(idx, coords.shape[0], 2, coords, leaf=8))
    assert (fz.use_inv, fz.chol) == (pol.nd_inv, pol.nd_chol)
    A = __import__("importlib").import_module(
        "multigridbarrier_tpu.solver.amgb"
    )
    g = mgb.fem2d(L=2)
    spec = A._normalize_D(A.default_D(2))
    ctx = A._SolverCtx(g, spec, A.default_Q(2, 1.0).barrier, g.x[:, :2])
    assert ctx.policy is pol
    assert not ctx._f32pc_on() and ctx._nd_cheap_engine() == "f32"
    assert ctx.newton_chunk == 4 and ctx.cg_maxiter == 200


def test_platform_policy_unknown_platform_raises(monkeypatch):
    import jax

    with pytest.raises(RuntimeError, match="no solver policy"):
        platform_policy("metal")
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="no solver policy"):
        platform_policy()
