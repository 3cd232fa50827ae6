"""Time the PRODUCTION per-Newton-iteration programs of the ND fine
path at a given L on the live backend, in both compositions the reuse
runner can execute:

  split (current endgame regime once f32pc is retired):
      nd_step_nodir (post+pre)  +  nd_dir_f (fresh f64 factor+solve)
  fused (_run_level_nd's program, = the CPU-measured-better shape):
      nd_step (post+pre+direction in ONE jit)
  cheap (mid-path regime):
      nd_step_nodir + nd_dir_f32 (fresh shifted-f32 factor + f64 PCG)

plus the blocking scalar device_get that closes each Newton iteration.
The split-vs-fused delta is the decision number for routing the
endgame through the fused program (round-2 session-7 measured fused
beating split by ~95ms/it on CPU from XLA cross-program fusion alone;
a saved dispatch round-trip adds to that on an accelerator).

Run on the device:  python -u tools/probe_step_programs.py [L] [t]
Run on CPU:  JAX_PLATFORMS=cpu python ...
"""

import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import importlib

import multigridbarrier_tpu as mgb

A = importlib.import_module("multigridbarrier_tpu.solver.amgb")

L = int(sys.argv[1]) if len(sys.argv) > 1 else 7
T = float(sys.argv[2]) if len(sys.argv) > 2 else 1.0e6


def timed(label, fn, *args, n=5):
    out = fn(*args)  # compile
    jax.block_until_ready(out)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    dt = min(ts)
    allts = " ".join(f"{t*1e3:.1f}" for t in ts)
    print(f"{label:44s} {dt*1e3:9.2f} ms   [{allts}]", flush=True)
    return out, dt


t_all0 = time.perf_counter()
g = mgb.fem2d(L=L)
print(f"# geometry L={L} built {time.perf_counter()-t_all0:.1f}s", flush=True)
spec = A._normalize_D(A.default_D(2))
dt_ = g.x.dtype
c0 = jax.vmap(lambda xi: jnp.asarray(A.default_f(2, dt_)(xi), dt_))(g.x)
ctx = A._SolverCtx(g, spec, A.default_Q(2, 1.0).barrier, c0)
level = ctx.levels - 1
h = ctx._get_nd(level)
basis = ctx._bases[level]
Pl = ctx._P[level]
rloc = basis.rloc
full_ids = h["nd_full_ids"]
cst = h["nd_consts"]
z = jax.vmap(lambda xi: jnp.asarray(A.default_g(2, dt_)(xi), dt_))(g.x)
t_arr = jnp.asarray(T, dt_)
print(f"# ctx ready {time.perf_counter()-t_all0:.1f}s; probing t={T:g}",
      flush=True)

# pre once to get a valid state
(vals, gv, y, cy, fy0), dt_pre = timed(
    "nd_pre (assembly half only)", h["nd_pre"],
    Pl, basis, ctx.x, ctx.w, ctx.c, z, t_arr, full_ids)

# fresh f64 direction (split endgame shape)
(dvp, fac), dt_dirf = timed(
    "nd_dir_f (f64 factor+solve, split)", h["nd_dir_f"], vals, gv, cst)

# f32pc direction (mid-path shape)
cap = jnp.int32(40)
delta = jnp.float32(3e-6)
(dvp32, its32, rel32), dt_dir32 = timed(
    "nd_dir_f32 (f32 factor + f64 PCG)", h["nd_dir_f32"],
    vals, gv, cst, cap, delta)
print(f"#   f32pc certify: its={int(its32)} rel={float(rel32):.2e}",
      flush=True)

# post+pre fused step (no direction)
out_step, dt_step = timed(
    "nd_step_nodir (post+pre)", h["nd_step_nodir"],
    Pl, basis, rloc, ctx.x, ctx.w, ctx.c, z, t_arr, y, cy, fy0, gv, dvp,
    full_ids)

# fully fused step (post+pre+f64 direction)
out_fused, dt_fused = timed(
    "nd_step FUSED (post+pre+f64 dir)", h["nd_step"],
    Pl, basis, rloc, ctx.x, ctx.w, ctx.c, z, t_arr, y, cy, fy0, gv, dvp,
    full_ids, cst)

# the blocking scalar fetch that closes an iteration
z2, lam2_d, alpha_d, dphi_d = out_fused[0], out_fused[1], out_fused[2], \
    out_fused[3]
t0 = time.perf_counter()
jax.device_get((lam2_d, alpha_d, dphi_d))
dt_get = time.perf_counter() - t0
print(f"{'scalar device_get (ready buffers)':44s} {dt_get*1e3:9.2f} ms",
      flush=True)

print()
print(f"# split endgame it  = step {dt_step*1e3:.0f} + dir_f "
      f"{dt_dirf*1e3:.0f} + get ~43  = "
      f"{(dt_step+dt_dirf)*1e3+43:.0f} ms", flush=True)
print(f"# fused endgame it  = fused {dt_fused*1e3:.0f} + get ~43  = "
      f"{dt_fused*1e3+43:.0f} ms", flush=True)
print(f"# cheap midpath it  = step {dt_step*1e3:.0f} + dir32 "
      f"{dt_dir32*1e3:.0f} + get ~43  = "
      f"{(dt_step+dt_dir32)*1e3+43:.0f} ms", flush=True)
print(f"# total probe wall {time.perf_counter()-t_all0:.1f}s", flush=True)
