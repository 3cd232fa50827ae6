"""Number formats and kernels kept for A/B runs, off the default path.

Current contents:
  dfmm.py — double-float (pair-f32) arithmetic and the batched base-block
    Cholesky / triangular-inverse kernels of the ND factor's df engine
    (MGB_ND_CHEAP=df, MGB_ND_BASE=df).  Built for hardware that emulates
    f64 in software; native-f64 platforms keep XLA's f64 kernels.
"""
