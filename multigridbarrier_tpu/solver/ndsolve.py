"""On-device nested-dissection multifrontal Cholesky — the sparse direct
solver for fine-level Newton systems.

Why a device-side direct solver
-------------------------------
The host sparse-direct path (hostsolve.py) is mathematically right but
economically wrong next to an accelerator: on a one-core host a SuperLU
factorization at fem2d L=7 (N=32k) costs ~3s, the endgame wants a
refactor every 1-2 Newton steps, and each stale-PCG Newton step burns
~0.9s of single-core triangular solves (t_solve reached 200s by t=1e4
at L=7) while the device idles between ~ms assembly kernels.  The reference's MUMPS runs the same algorithm
multithreaded on 10 laptop cores (docs/src/guide.md:221-238); a 1-core
Python host cannot match it.  The accelerator can.

A multifrontal factorization is a SCHEDULE OF DENSE OPERATIONS: batched
Cholesky of supernode diagonal blocks, batched triangular solves,
batched Schur-complement updates.  Those are exactly the primitives an
accelerator executes well, and the schedule is STATIC per sparsity
pattern — XLA compiles it once and nothing re-plans inside the Newton
loop (the same design rule as runtime/elements.py).  The sparse
structure lives entirely in precomputed gather/scatter index arrays;
the numeric phase is pure batched dense algebra + segment-sums, and it
drops INSIDE the Newton-step jit: assemble -> factor -> solve -> line
search with zero host round-trips.

Structure
---------
* NDSymbolic (host, numpy, cached per level): geometric nested
  dissection of the mesh-node graph (coordinate median bisection with a
  one-sided vertex separator), elimination tree, front groups (per tree
  depth, optionally split into front-size classes — MGB_ND_BUCKET —
  because per-depth shape padding costs cubically on the outlier
  front), and three families of DOF-LEVEL index maps so the numeric
  phase needs no layout passes at all:
    - assembly:  flat vals index -> interleaved (front, row, col) dof;
    - extend-add: child Schur dof pair -> ancestor front dof pair,
      fanned in DIRECTLY to the deeper owner (additivity of F_BB
      through intermediate eliminations makes hop-by-hop extend-add
      unnecessary);
    - solve:     global dof id <-> (front, slot) for the two sweeps,
      with separate pad read/write sinks (no pad-reset scatters).
  The `vals` input is the SAME deduplicated segment-sum array the host
  path uses (hostsolve.HostPattern layout: ((f1*nf+f2)*nuniq + pid)).
* NDFactorizer (jax, jittable): an unrolled loop over front groups
  (deepest first), each group one batch of fronts with identical padded
  shapes; per group ONE combined segment_sum assembles matrix values +
  child Schur contributions + pad unit diagonals straight into the
  interleaved dense fronts.  ~7 ops per group: a factorization is a
  few hundred XLA ops of batched dense algebra — device-time near the
  per-op latency floor instead of seconds of single-core SuperLU.

Numerics match the on-device dense path (linsolve.dense_solve): the
factorization is UNSHIFTED (a diagonal shift destroys the Newton
direction at barrier conditioning); pad slots carry an identity
diagonal; floor-singular blocks surface as NaNs which the caller
detects and escalates exactly like the dense path's shift ladder.

Reference parity: replaces MUMPS in the reference's solve hook
(src/MultiGridBarrierMPI.jl:233-247) with an architecture the reference
cannot express — its MUMPS call is an opaque host library; here the
factorization is XLA ops on the accelerator, sharing the compile
cache, dtype policy, and jit boundary with the rest of the solver.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np

import jax
import jax.numpy as jnp


def narrow_idx(a):
    """Index arrays as device operands: int32 when they fit (the big maps
    are tens of MB, and int32 halves them), int64 otherwise."""
    a = np.asarray(a)
    if a.size == 0 or a.max() < np.iinfo(np.int32).max:
        a = a.astype(np.int32)
    return jnp.asarray(a)


# ---------------------------------------------------------------------------
# Symbolic phase (host, numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Front:
    sep: np.ndarray  # node ids eliminated at this front
    bd: np.ndarray  # boundary node ids (strict-ancestor separator nodes)
    depth: int
    parent: int


def _build_tree(adj, coords, leaf: int):
    """Recursive coordinate-median bisection with one-sided vertex
    separators (sep = p0 nodes adjacent to p1, detected via one CSR
    row-slice per level)."""
    fronts: List[_Front] = []

    def rec(nodes: np.ndarray, depth: int, parent: int) -> int:
        if len(nodes) <= leaf:
            i = len(fronts)
            fronts.append(_Front(sep=nodes, bd=None, depth=depth, parent=parent))
            return i
        c = coords[nodes]
        spans = c.max(axis=0) - c.min(axis=0)
        dim = int(np.argmax(spans))
        med = np.median(c[:, dim])
        mask = c[:, dim] <= med
        if mask.all() or not mask.any():
            order = np.argsort(c[:, dim], kind="stable")
            mask = np.zeros(len(nodes), bool)
            mask[order[: len(nodes) // 2]] = True
        p0, p1 = nodes[mask], nodes[~mask]
        in_p1 = np.zeros(coords.shape[0], bool)
        in_p1[p1] = True
        sep_mask = np.asarray(
            (adj[p0][:, in_p1.nonzero()[0]]).getnnz(axis=1) > 0
        )
        sep = p0[sep_mask]
        rest0 = p0[~sep_mask]
        i = len(fronts)
        fronts.append(_Front(sep=sep, bd=None, depth=depth, parent=parent))
        if len(rest0):
            rec(rest0, depth + 1, i)
        if len(p1):
            rec(p1, depth + 1, i)
        return i

    rec(np.arange(coords.shape[0]), 0, -1)
    return fronts


class NDSymbolic:
    """Symbolic factorization: tree, per-depth buckets, and index maps.

    `idx` (nelem, nl) node ids with pad slot m, `m` real nodes, `nf`
    fields, `coords` (m, dim) node coordinates for the bisection."""

    def __init__(self, idx: np.ndarray, m: int, nf: int, coords: np.ndarray,
                 leaf: int = 16):
        import scipy.sparse as sp

        idx = np.asarray(idx)
        self.m, self.nf = int(m), int(nf)
        keys = (
            idx[:, :, None].astype(np.int64) * (m + 1) + idx[:, None, :]
        ).reshape(-1)
        uniq = np.unique(keys)
        self.nuniq = len(uniq)
        pi = uniq // (m + 1)
        pj = uniq % (m + 1)
        real = (pi < m) & (pj < m)
        ii, jj = pi[real], pj[real]
        off = ii != jj
        A = sp.csr_matrix(
            (np.ones(int(off.sum())), (ii[off], jj[off])), shape=(m, m)
        )
        A = ((A + A.T) > 0).astype(np.int8).tocsr()

        fronts = _build_tree(A, np.asarray(coords), leaf)
        nfr = len(fronts)
        depth_of = np.array([f.depth for f in fronts])
        parent = np.array([f.parent for f in fronts])

        # boundaries bottom-up: bd(t) = (adj(sep t) U bd(children)) \ sep(t),
        # then keep only strict-ancestor-owned nodes
        owner = np.full(m, -1, np.int64)
        for i, f in enumerate(fronts):
            owner[f.sep] = i
        order = sorted(range(nfr), key=lambda i: -depth_of[i])
        bd_sets = [set() for _ in range(nfr)]
        sub_up = [set() for _ in range(nfr)]
        anc_cache: dict = {}

        def ancestors(i):
            if i not in anc_cache:
                s = set()
                j = parent[i]
                while j >= 0:
                    s.add(j)
                    j = parent[j]
                anc_cache[i] = s
            return anc_cache[i]

        for i in order:
            f = fronts[i]
            s = set()
            if len(f.sep):
                nbr = A.indices[
                    np.concatenate(
                        [
                            np.arange(A.indptr[u], A.indptr[u + 1])
                            for u in f.sep
                        ]
                    )
                ] if len(f.sep) else np.empty(0, np.int64)
                s.update(nbr.tolist())
            s |= sub_up[i]
            s -= set(f.sep.tolist())
            anc = ancestors(i)
            s = {u for u in s if owner[u] in anc}
            bd_sets[i] = s
            if parent[i] >= 0:
                sub_up[parent[i]] |= s
        for i, f in enumerate(fronts):
            f.bd = np.fromiter(
                sorted(bd_sets[i], key=lambda u: (depth_of[owner[u]], u)),
                np.int64,
                len(bd_sets[i]),
            )

        self.fronts = fronts
        self.owner = owner
        self.parent = parent
        maxd = int(depth_of.max())
        self.maxd = maxd

        # -- grouping: the numeric phase batches fronts with identical
        # padded shapes.  Base groups = tree depths.  MGB_ND_BUCKET=1
        # (the default) additionally splits each depth into
        # front-size classes
        # (F = sep+bd rounded up on a geometric grid): per-depth shape
        # padding costs CUBICALLY on the outlier front (measured 3.4x
        # the actual factor flops at fem2d L=7), and when the f64 matmul
        # rate — not the per-op latency — is the bottleneck, ~3x fewer
        # flops beats ~3x fewer batches.  Ordering: groups ascend by
        # (depth, class); the factorization walks them in reverse, and
        # every extend-add target is a STRICT ancestor (smaller depth),
        # so any within-depth class order is schedule-valid.
        # measured: 20% faster end-to-end on the (flop-bound) 1-core CPU
        # at fem2d L=6/L=7 with identical iteration counts; where per-op
        # latency rather than flops bounds the factor, the extra
        # (smaller) batches may cost more than the flop cut saves.
        bucket = os.environ.get("MGB_ND_BUCKET", "1") == "1"
        _grid = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512,
                 768, 1024, 1536)

        def _fclass(F):
            for gv in _grid:
                if F <= gv:
                    return gv
            return int(F)

        gmap: dict = {}
        for i, f in enumerate(fronts):
            kk = (
                (int(depth_of[i]), _fclass(len(f.sep) + len(f.bd)))
                if bucket
                else (int(depth_of[i]),)
            )
            gmap.setdefault(kk, []).append(i)
        gkeys = sorted(gmap)
        by_depth = [gmap[kk] for kk in gkeys]  # "by group"
        self.by_depth = by_depth
        self.ngroups = len(by_depth)
        self.group_of = np.full(nfr, -1, np.int64)
        for gi, ids in enumerate(by_depth):
            self.group_of[ids] = gi
        self.s_pad = [
            max((len(fronts[i].sep) for i in ids), default=0) or 1
            for ids in by_depth
        ]
        self.b_pad = [
            max((len(fronts[i].bd) for i in ids), default=0)
            for ids in by_depth
        ]
        self.local_id = np.full(nfr, -1, np.int64)
        for ids in by_depth:
            for k, i in enumerate(ids):
                self.local_id[i] = k

        # (front, node) -> padded slot lookup via sorted key array
        slot_keys, slot_vals = [], []
        for i, f in enumerate(fronts):
            if len(f.sep):
                slot_keys.append(np.int64(i) * m + f.sep)
                slot_vals.append(np.arange(len(f.sep), dtype=np.int64))
            if len(f.bd):
                slot_keys.append(np.int64(i) * m + f.bd)
                slot_vals.append(
                    self.s_pad[self.group_of[i]]
                    + np.arange(len(f.bd), dtype=np.int64)
                )
        self._slot_keys = np.concatenate(slot_keys)
        so = np.argsort(self._slot_keys, kind="stable")
        self._slot_keys = self._slot_keys[so]
        self._slot_vals = np.concatenate(slot_vals)[so]
        self.depth_of = depth_of
        self._build_maps(pi, pj, real)
        self._build_solve_maps()

    def _slots(self, front_ids: np.ndarray, nodes: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(self._slot_keys, front_ids * self.m + nodes)
        return self._slot_vals[pos]

    def _build_maps(self, pi, pj, real):
        nf = self.nf
        ng = self.ngroups
        depth_of, owner = self.depth_of, self.owner
        group_of = self.group_of
        Fn = [self.s_pad[d] + self.b_pad[d] for d in range(ng)]

        # -- assembly (vectorized over all real pairs) ---------------------
        pids = np.nonzero(real)[0]
        i_n, j_n = pi[pids], pj[pids]
        # exact pair-block matvec + Jacobi fallback support (IR rounds in
        # the in-jit direction computation, amgb._build_nd_step)
        self.pair_pid = pids
        self.pair_i = i_n
        self.pair_j = j_n
        uniq_keys = pi * (self.m + 1) + pj
        self.diag_pid = np.searchsorted(
            uniq_keys, np.arange(self.m, dtype=np.int64) * (self.m + 2)
        )
        # node ids for EVERY unique pair slot (pad node -> m): the f32
        # factor path needs them to apply symmetric Jacobi equilibration
        # to the whole vals array before the cast
        self.pair_i_all = np.minimum(pi, self.m)
        self.pair_j_all = np.minimum(pj, self.m)
        oi, oj = owner[i_n], owner[j_n]
        t = np.where(depth_of[oi] >= depth_of[oj], oi, oj)
        si = self._slots(t, i_n)
        sj = self._slots(t, j_n)
        td = group_of[t]
        k = self.local_id[t]
        # DOF-LEVEL maps: the combined segment_sum produces the
        # field-interleaved dense fronts directly — no pair-block
        # interleave/deinterleave transposes and no vals transpose in
        # the numeric phase (those were 3 full-front-buffer layout ops
        # per group).  asm_pid indexes the FLAT vals array
        # ((f1*nf+f2)*nuniq + pid); dst = (k*F + si*nf+f1)*F + sj*nf+f2.
        f1 = np.repeat(np.arange(nf, dtype=np.int64), nf)
        f2 = np.tile(np.arange(nf, dtype=np.int64), nf)
        nuniq = self.nuniq
        self.asm_pid: List[np.ndarray] = []
        self.asm_dst: List[np.ndarray] = []
        for d in range(ng):
            sel = td == d
            F = Fn[d] * nf
            p_sel = pids[sel]
            self.asm_pid.append(
                ((f1 * nf + f2) * nuniq)[None, :] + p_sel[:, None]
            )
            self.asm_dst.append(
                (
                    (k[sel, None] * Fn[d] + si[sel, None]) * nf + f1
                ) * F
                + sj[sel, None] * nf
                + f2
            )
            self.asm_pid[-1] = self.asm_pid[-1].reshape(-1)
            self.asm_dst[-1] = self.asm_dst[-1].reshape(-1)

        # -- pad identity as pair-block destinations: pad slot s of front
        # k contributes an eye(nf) block at pair (s, s).  Riding these
        # through the same combined segment_sum as assembly/extend-add
        # avoids a separate (n_d, F, F) masked-eye add per depth (whose
        # dense constant form was also ~360MB at L=7).
        self.pad_ids: List[np.ndarray] = []
        for d in range(ng):
            ids = []
            F = Fn[d] * nf
            for kk, i in enumerate(self.by_depth[d]):
                f = self.fronts[i]
                pads = list(range(len(f.sep), self.s_pad[d])) + [
                    self.s_pad[d] + b
                    for b in range(len(f.bd), self.b_pad[d])
                ]
                for s in pads:
                    for ff in range(nf):
                        dof = s * nf + ff
                        ids.append((kk * F + dof) * F + dof)
            self.pad_ids.append(np.asarray(ids, np.int64))

        # -- extend-add: Schur pair (front i, a, b) -> deeper-owner front --
        self.ea_src: List[np.ndarray] = []
        self.ea_dst: List[np.ndarray] = []
        self.ea_tgt: List[np.ndarray] = []
        Fn_arr = np.asarray(Fn)
        for d in range(ng):
            Bn = self.b_pad[d]
            Bf = Bn * nf
            ids = [i for i in self.by_depth[d] if len(self.fronts[i].bd)]
            if not ids:
                self.ea_src.append(np.empty(0, np.int64))
                self.ea_dst.append(np.empty(0, np.int64))
                self.ea_tgt.append(np.empty(0, np.int64))
                continue
            # vectorized over ALL fronts of the group (the per-front
            # python loop was 23s of a 30s L=8 symbolic build)
            Bi = np.asarray([len(self.fronts[i].bd) for i in ids])
            kk_f = self.local_id[np.asarray(ids)]
            bd_cat = np.concatenate([self.fronts[i].bd for i in ids])
            offs = np.concatenate([[0], np.cumsum(Bi)])[:-1]
            P = Bi * Bi
            pair_front = np.repeat(np.arange(len(ids)), P)
            pos = np.arange(int(P.sum())) - np.repeat(
                np.concatenate([[0], np.cumsum(P)])[:-1], P
            )
            Bi_p = Bi[pair_front]
            a_id = pos // Bi_p
            b_id = pos % Bi_p
            ua = bd_cat[offs[pair_front] + a_id]
            ub = bd_cat[offs[pair_front] + b_id]
            oa, ob = owner[ua], owner[ub]
            tt = np.where(depth_of[oa] >= depth_of[ob], oa, ob)
            ss_i = self._slots(tt, ua)
            ss_j = self._slots(tt, ub)
            ttd = group_of[tt]
            kt = self.local_id[tt]
            Fnt = Fn_arr[ttd]
            Ft = Fnt * nf
            kk_p = kk_f[pair_front]
            # dof-level expansion (nf^2 combos per node pair)
            src = (
                ((kk_p * np.int64(Bn) + a_id)[:, None] * nf + f1) * Bf
                + b_id[:, None] * nf
                + f2
            ).reshape(-1)
            dst = (
                ((kt * Fnt + ss_i)[:, None] * nf + f1) * Ft[:, None]
                + ss_j[:, None] * nf
                + f2
            ).reshape(-1)
            self.ea_src.append(src)
            self.ea_dst.append(dst)
            self.ea_tgt.append(np.repeat(ttd, nf * nf))

        # -- flat Schur-buffer layout + extend-add regrouped by TARGET --
        # Children write their (Bn x Bn) Schur pair-blocks once into a
        # single flat buffer (static per-depth offsets); each ancestor
        # depth then GATHERS its contributions inside the one combined
        # assembly segment_sum.  This replaces the old per-(source,
        # target)-depth scatter+add chain — ~maxd^2/2 segment_sums and
        # adds per factorization — with exactly one scatter per depth.
        self.sb_off = np.zeros(ng + 1, np.int64)
        for d in range(ng):
            n_d = len(self.by_depth[d])
            Bf = self.b_pad[d] * nf
            self.sb_off[d + 1] = self.sb_off[d] + n_d * Bf * Bf
        tsrc: List[List[np.ndarray]] = [[] for _ in range(ng)]
        tdst: List[List[np.ndarray]] = [[] for _ in range(ng)]
        for d in range(ng):
            tgt = self.ea_tgt[d]
            for td in np.unique(tgt):
                sel = tgt == td
                tsrc[int(td)].append(self.sb_off[d] + self.ea_src[d][sel])
                tdst[int(td)].append(self.ea_dst[d][sel])
        self.ea_tsrc = [
            np.concatenate(s) if s else np.empty(0, np.int64) for s in tsrc
        ]
        self.ea_tdst = [
            np.concatenate(s) if s else np.empty(0, np.int64) for s in tdst
        ]

        # -- relay extend-add (MGB_ND_EA=relay): child Schur -> PARENT
        # front (classic multifrontal relay; exact-arithmetic-identical
        # to the direct fan-in by extend-add associativity).  The fan-in
        # moves 8.99M random f64 elements through one flat
        # gather+scatter per factor at fem2d L=7; the relay replaces it
        # with per-group batch gathers + one-hot selection matmuls + a
        # block-granular segment_sum over
        # ~2 children per parent.  bd(child) ⊆ sep(parent) ∪ bd(parent)
        # by construction (bd sets propagate through sub_up), so the
        # parent front always has slots for every child Schur entry.
        # relay_in[gp] = [(gc, cidx, pkk, rowmap_dof)]: child fronts
        # cidx (local ids in group gc, sorted by parent), their parents'
        # local ids pkk in gp, and rowmap_dof (nc, Fn[gp]*nf) mapping
        # parent dof-slot -> child Schur dof-row (Bf = padded zero row).
        self.relay_in: List[List] = [[] for _ in range(ng)]
        for gc in range(ng):
            Bn = self.b_pad[gc]
            if Bn == 0:
                continue
            by_pg: dict = {}
            for k, i in enumerate(self.by_depth[gc]):
                p = int(self.parent[i])
                if p < 0 or len(self.fronts[i].bd) == 0:
                    continue
                by_pg.setdefault(int(group_of[p]), []).append((k, i, p))
            Bf = Bn * nf
            for gp, lst in sorted(by_pg.items()):
                lst.sort(key=lambda kip: self.local_id[kip[2]])
                cidx = np.asarray([k for k, i, p in lst], np.int64)
                pkk = np.asarray(
                    [self.local_id[p] for k, i, p in lst], np.int64
                )
                Fp = Fn[gp]
                rowmap = np.full((len(lst), Fp), -1, np.int64)
                for r_, (k, i, p) in enumerate(lst):
                    bd = self.fronts[i].bd
                    sl = self._slots(np.full(len(bd), p, np.int64), bd)
                    rowmap[r_, sl] = np.arange(len(bd), dtype=np.int64)
                # dof-level: parent dof slot -> child Schur dof row;
                # unmapped slots -> Bf (the padded zero row)
                rdof = np.where(
                    rowmap[:, :, None] < 0,
                    np.int64(Bf),
                    rowmap[:, :, None] * nf
                    + np.arange(nf, dtype=np.int64)[None, None, :],
                ).reshape(len(lst), Fp * nf)
                self.relay_in[gp].append((gc, cidx, pkk, rdof))

    def _build_solve_maps(self):
        """Gather/scatter dof maps for the two triangular sweeps.

        Pad slots use SEPARATE read and write sinks: gathers read slot N
        (never written, stays zero) while scatters write slot N+1 (never
        read) — so no per-depth pad-reset scatter is needed in the
        sweeps (each `.at[-1].set(0.0)` was one more serialized scatter
        per depth)."""
        nf = self.nf
        self.sep_gids: List[np.ndarray] = []
        self.bd_gids: List[np.ndarray] = []
        self.sep_gids_w: List[np.ndarray] = []
        self.bd_gids_w: List[np.ndarray] = []
        N = self.m * nf
        self.N = N
        for d in range(self.ngroups):
            n_d = len(self.by_depth[d])
            sg = np.full((n_d, self.s_pad[d] * nf), N, np.int64)
            bg = np.full((n_d, max(self.b_pad[d], 1) * nf), N, np.int64)
            for k, i in enumerate(self.by_depth[d]):
                f = self.fronts[i]
                if len(f.sep):
                    g = (f.sep[:, None] * nf + np.arange(nf)).reshape(-1)
                    sg[k, : len(g)] = g
                if len(f.bd):
                    g = (f.bd[:, None] * nf + np.arange(nf)).reshape(-1)
                    bg[k, : len(g)] = g
            self.sep_gids.append(sg)
            self.bd_gids.append(bg)
            self.sep_gids_w.append(np.where(sg == N, N + 1, sg))
            self.bd_gids_w.append(np.where(bg == N, N + 1, bg))


# ---------------------------------------------------------------------------
# Numeric phase (jax, jittable)
# ---------------------------------------------------------------------------


def _mm_native(A, B):
    return A @ B


def _round_bits(x, q: int):
    """Round-to-nearest truncation of f64 mantissas to q bits (Veltkamp
    splitting, exact in f64 arithmetic).  The factor-precision SIMULATOR:
    applying it at every stage output of the multifrontal schedule
    models a factorization computed in q-bit arithmetic (double-float
    pair-f32 ~ 48 bits, f32 ~ 24) without building that arithmetic —
    used to decide, on CPU, which precision profile still yields a
    certifiable preconditioner at endgame conditioning before any
    kernel work."""
    if q >= 53:
        return x
    c = jnp.asarray(float(1 + (1 << (53 - q))), x.dtype)
    t = x * c
    return t - (t - x)


def _df_chol(Ajj, n: int):
    """Base-block Cholesky in pair-f32 (double-float) arithmetic.

    For hardware that emulates f64 in software, where the f64 Cholesky
    expander is the costliest op of the multifrontal factor
    (tools/probe_df32_cost.py times the two).  Pair-f32 carries ~2^-44..48
    accuracy, which certifies barrier Newton directions through t~1e5
    unshifted (tools/probe_qbits_direction.py) — the caller gates
    acceptance exactly like f32pc, so path honesty is structural."""
    from ..experimental import dfmm

    return dfmm.to_f64(dfmm.chol_looped(dfmm.from_f64(Ajj), n))


def _df_tri_inv(Ljj, n: int):
    """Base-block lower-triangular inverse in pair-f32 (see _df_chol)."""
    from ..experimental import dfmm

    return dfmm.to_f64(
        dfmm.tri_lower_inv_looped(dfmm.from_f64(Ljj), n)
    )


def _tri_inv_blocked(Ls, base: int = 32, mm=_mm_native, base_impl="xla",
                     pin_rows=None):
    """Explicit inverse of batched lower-triangular (n_d, s, s) matrices
    by block doubling: invert base-size diagonal blocks once (one small
    batched substitution), then combine upward with batched matmuls —
    inv([[A,0],[C,B]]) = [[Ai,0],[-Bi C Ai, Bi]].  The dominant work is
    batched matmuls of shape (n_d*nb, b, b) instead of XLA's sequential
    per-panel triangular substitution.  ~6 ops per doubling level,
    log2(s/base) levels.

    Pads s up to a power-of-two multiple of base with an identity
    diagonal (the padded inverse restricts to the true inverse)."""
    n_d, s, _ = Ls.shape
    dtype = Ls.dtype
    nb0 = max(1, -(-s // base))
    nb = 1 << (nb0 - 1).bit_length()  # next power of two
    S = nb * base
    if S != s:
        # identity on the pad diagonal via pad + masked-eye add (an
        # .at[:s,:s].set would lower to a scatter)
        ar = jnp.arange(S)
        eye_pad = (
            (ar[:, None] == ar[None, :]) & (ar[:, None] >= s)
        ).astype(dtype)
        Lp = jnp.pad(Ls, ((0, 0), (0, S - s), (0, S - s))) + eye_pad[None]
    else:
        Lp = Ls
    # invert the base diagonal blocks (batched small substitution)
    ar_b = jnp.arange(base)
    eye_b = (ar_b[:, None] == ar_b[None, :]).astype(dtype)
    idx = jnp.arange(nb)
    Db = Lp.reshape(n_d, nb, base, nb, base)[:, idx, :, idx, :]
    # advanced indexing puts the paired axis first: (nb, n_d, base, base)
    Db = jnp.swapaxes(Db, 0, 1).reshape(n_d * nb, base, base)
    if base_impl == "df":
        blocks = _df_tri_inv(Db, base).reshape(n_d, nb, base, base)
    else:
        blocks = jax.scipy.linalg.solve_triangular(
            Db, eye_b[None] * jnp.ones((n_d * nb, 1, 1), dtype), lower=True
        ).reshape(n_d, nb, base, base)
    # block doubling, scatter-free: the inverse is carried as the batch
    # of diagonal blocks (n_d, nb, b, b) and each level assembles the
    # doubled blocks [[Ai,0],[X,Bi]] with concatenations.
    b = base
    while b < S:
        nb2 = S // (2 * b)
        i2 = jnp.arange(nb2)
        Lv = Lp.reshape(n_d, nb2, 2, b, nb2, 2, b)
        C = jnp.swapaxes(Lv[:, i2, 1, :, i2, 0, :], 0, 1)  # (n_d,nb2,b,b)
        Ai = blocks[:, 0::2]
        Bi = blocks[:, 1::2]
        if pin_rows is not None:
            # within-front sharding (see NDFactorizer._wide_pin): the
            # doubling matmuls carry the cubic work of the top-tree
            # fronts — shard each block's row axis over the mesh
            C = pin_rows(C, 2)
            Bi = pin_rows(Bi, 2)
            X = -pin_rows(mm(Bi, pin_rows(mm(C, Ai), 2)), 2)
        else:
            X = -mm(Bi, mm(C, Ai))
        top = jnp.concatenate([Ai, jnp.zeros_like(X)], axis=-1)
        bot = jnp.concatenate([X, Bi], axis=-1)
        blocks = jnp.concatenate([top, bot], axis=-2)
        b *= 2
    return blocks[:, 0, :s, :s]


def _chol_blocked(Af, base: int = 32, mm=_mm_native, base_impl="xla",
                  pin_rows=None):
    """Batched Cholesky of (n_d, s, s) SPD matrices by right-looking
    panel factorization: per panel one small batched Cholesky + one
    small batched substitution + two batched matmuls (matmul-dominant,
    scatter-free — column panels accumulate in a list and concatenate).
    Alternative to XLA's CholeskyExpander While-loop lowering; A/B via
    MGB_ND_CHOL=blocked|xla."""
    n_d, s, _ = Af.shape
    dtype = Af.dtype
    nb = max(1, -(-s // base))
    S = nb * base
    if S != s:
        ar = jnp.arange(S)
        eye_pad = (
            (ar[:, None] == ar[None, :]) & (ar[:, None] >= s)
        ).astype(dtype)
        X = jnp.pad(Af, ((0, 0), (0, S - s), (0, S - s))) + eye_pad[None]
    else:
        X = Af
    ar_b = jnp.arange(base)
    eye_b = (ar_b[:, None] == ar_b[None, :]).astype(dtype)
    cols = []
    for j in range(nb):
        Ajj = X[:, :base, :base]
        if base_impl == "df":
            Ljj = _df_chol(Ajj, base)
        else:
            Ljj = jnp.linalg.cholesky(Ajj)
        parts = [jnp.zeros((n_d, j * base, base), dtype), Ljj]
        if nb - j > 1:
            if base_impl == "df":
                Linv = _df_tri_inv(Ljj, base)
            else:
                Linv = jax.scipy.linalg.solve_triangular(
                    Ljj, eye_b[None] * jnp.ones((n_d, 1, 1), dtype),
                    lower=True,
                )
            R = X[:, base:, :base]
            if pin_rows is not None:
                # within-front sharding: the panel update and trailing
                # Schur matmuls hold the O(F^3) work of a root front —
                # shard their row axis over the mesh (base blocks and
                # Linv stay replicated; GSPMD gathers the thin panel)
                R = pin_rows(R, 1)
                Lj = pin_rows(mm(R, jnp.swapaxes(Linv, -1, -2)), 1)
                X = pin_rows(
                    X[:, base:, base:] - mm(Lj, jnp.swapaxes(Lj, -1, -2)),
                    1,
                )
            else:
                Lj = mm(R, jnp.swapaxes(Linv, -1, -2))
                X = X[:, base:, base:] - mm(Lj, jnp.swapaxes(Lj, -1, -2))
            parts.append(Lj)
        cols.append(jnp.concatenate(parts, axis=1))
    L = jnp.concatenate(cols, axis=2)
    return L[:, :s, :s]


class NDFactorizer:
    """Device-resident factor/solve built from an NDSymbolic schedule.

    factor(vals, consts) and solve(fac, b, consts) are pure jittable
    functions; drop them inside the Newton-step jit and the whole
    linear solve runs on the accelerator.  The index maps are NOT
    closed over — `consts = factorizer.consts()` must be passed as a
    runtime argument so the (tens of MB at L>=7) maps are device
    operands instead of literal constants serialized into the HLO."""

    def __init__(self, sym: NDSymbolic, dtype=jnp.float64,
                 use_inv: bool = None, mesh=None, policy=None):
        from ..options import platform_policy

        if policy is None:
            policy = platform_policy()
        self.sym = sym
        self.dtype = dtype
        # Distributed factorization (the reference's MUMPS is a
        # distributed-memory parallel solver, docs/src/installation.md:13):
        # fronts within a group are independent batched dense ops, so the
        # front-batch axis shards over the 'dof' mesh axis — each device
        # factors ~n_d/ndev fronts and the extend-add/solve traffic
        # becomes GSPMD-inserted collectives.  Top-of-tree groups with
        # fewer fronts than devices stay replicated (they are the
        # sequential tail of any multifrontal schedule).
        self.mesh = mesh
        # Triangular application policy: substitution (backward-stable)
        # vs multiply-by-explicit-inverse (batched matmuls: ONE
        # substitution per factor and a matmul per use, for hardware
        # whose triangular solves are slow).  Measured fem2d L=6 CPU:
        # Linv costs ~1e-6 objective drift and +10% Newton its at the
        # f64 floor.  Default from the platform policy (MGB_ND_INV).
        if use_inv is None:
            env = os.environ.get("MGB_ND_INV")
            use_inv = env == "1" if env is not None else policy.nd_inv
        self.use_inv = bool(use_inv)
        # Explicit-inverse construction: 'xla' = solve_triangular vs
        # identity (sequential panel substitution); 'blocked' = block-
        # doubling matmul inverse (_tri_inv_blocked; matmul-dominant).
        self.tri_inv = os.environ.get("MGB_ND_TRIINV", "blocked")
        # Cholesky engine: XLA's batched Cholesky (LAPACK on CPU,
        # cuSOLVER on GPU) vs the blocked right-looking panel form
        # (_chol_blocked).  Default from the platform policy.
        self.chol = os.environ.get("MGB_ND_CHOL", policy.nd_chol)
        # Base-block kernel engine for f64 factors: 'xla' = native f64,
        # 'df' = pair-f32 double-float (~2^-44..48; see _df_chol).  Only
        # meaningful with blocked kernels; f32 factors always keep xla.
        self.base_impl = os.environ.get("MGB_ND_BASE", "xla")
        # assembly scatter shape: 0 = one concat+segment_sum per group,
        # 1 = split the extend-add into its own scatter-add (lets XLA
        # fuse the Schur gather into the scatter instead of
        # materializing the concat buffer)
        self.split_sum = os.environ.get("MGB_ND_SPLITSUM", "0") == "1"
        # extend-add structure: 'fanin' = flat Schur buffer + one
        # combined segment_sum per group (deepest-owner targets);
        # 'relay' = classic multifrontal relay through the parent as
        # batch gathers + selection contractions (see NDSymbolic
        # relay_in), which turns the fanin scatter into batch gathers and
        # selection contractions.
        self.ea_mode = os.environ.get("MGB_ND_EA", "fanin")
        # relay column selection: 'mm' = one-hot matmul, 'gather' =
        # take_along_axis on the lane axis (moves less than the one-hot
        # matmul computes).
        self.relay_cols = os.environ.get("MGB_ND_RELAY_COLS", "gather")
        # relay extend-add scatter granularity: segment_sum over whole
        # F x F fronts until the per-update window exceeds this many MB,
        # then row-level segments (see the factor loop); the largest L=7
        # window is 3.91MB f64, the L=8 root 7.8MB.  0 forces rows.
        self.ea_row_mb = float(os.environ.get("MGB_ND_EA_ROWMB", "4"))
        # Panel width for the blocked Cholesky / block-doubling inverse:
        # at base=32 the F=694 root front of L=7 runs 22 sequential
        # panels of ~5 ops each.  Wider panels trade matmul flops for
        # fewer sequential stages.
        self.panel = int(os.environ.get("MGB_ND_PANEL", "32"))
        # Within-front sharding (the Amdahl fix for the elimination
        # tree's top: SCALING.md §3 — batch-axis sharding saturates at
        # ~2.2-2.4x because the top log2(N) depths hold the cubically-
        # dominant fronts on one device).  For replicated-batch groups
        # whose front is at least MGB_ND_WIDE_MIN rows, the blocked
        # Cholesky/inverse panel matmuls and the Schur update are
        # row-sharded over the mesh (the 2-D distribution role of
        # MUMPS' block-cyclic root front).
        self.shard_wide = os.environ.get("MGB_ND_SHARD_WIDE", "1") == "1"
        self.wide_min = int(os.environ.get("MGB_ND_WIDE_MIN", "128"))
        # Factor-precision simulator (see _round_bits): None = off; an
        # int truncates every stage output of an f64 factorization to
        # that many mantissa bits; a list gives per-GROUP bit widths
        # (index = group id d, ascending depth — hybrid profiles like
        # f32-quality leaves under f64 roots).  Set directly by probes/
        # tests; not a production knob.
        self.qbits = None

    def consts(self):
        """Device-operand pytree of all index maps (pass to factor and
        solve as an argument; build once per level and reuse).

        asm_dst is the PRE-CONCATENATED destination array for the one
        combined per-depth segment_sum: assembly pairs, then extend-add
        gathers from the flat Schur buffer, then pad-identity blocks.
        Maps are narrowed to int32 when they fit — they are tens of MB
        at L>=7."""
        sym = self.sym
        idx = narrow_idx
        # exactly ONE family of destination maps is materialized (they
        # are the largest device operands, ~150MB at L=8): the combined
        # concat+single-scatter form by default, or the split form
        # under the MGB_ND_SPLITSUM A/B flag.
        if self.ea_mode == "relay":
            dst = dict(
                asm_dst=None,
                asm_dst_nea=[
                    idx(np.concatenate([sym.asm_dst[d], sym.pad_ids[d]]))
                    for d in range(sym.ngroups)
                ],
                ea_tdst=None,
                relay=[
                    [
                        (idx(cidx), idx(pkk), idx(rdof))
                        for (gc, cidx, pkk, rdof) in sym.relay_in[d]
                    ]
                    for d in range(sym.ngroups)
                ],
            )
            return dict(
                asm_pid=[idx(a) for a in sym.asm_pid],
                ea_tsrc=None,
                sep_gids=[idx(a) for a in sym.sep_gids],
                bd_gids=[idx(a) for a in sym.bd_gids],
                sep_gids_w=[idx(a) for a in sym.sep_gids_w],
                bd_gids_w=[idx(a) for a in sym.bd_gids_w],
                **dst,
            )
        if self.split_sum:
            dst = dict(
                asm_dst=None,
                asm_dst_nea=[
                    idx(np.concatenate([sym.asm_dst[d], sym.pad_ids[d]]))
                    for d in range(sym.ngroups)
                ],
                ea_tdst=[idx(a) for a in sym.ea_tdst],
            )
        else:
            dst = dict(
                asm_dst=[
                    idx(
                        np.concatenate(
                            [sym.asm_dst[d], sym.ea_tdst[d], sym.pad_ids[d]]
                        )
                    )
                    for d in range(sym.ngroups)
                ],
                asm_dst_nea=None,
                ea_tdst=None,
            )
        return dict(
            asm_pid=[idx(a) for a in sym.asm_pid],
            ea_tsrc=[idx(a) for a in sym.ea_tsrc],
            sep_gids=[idx(a) for a in sym.sep_gids],
            bd_gids=[idx(a) for a in sym.bd_gids],
            sep_gids_w=[idx(a) for a in sym.sep_gids_w],
            bd_gids_w=[idx(a) for a in sym.bd_gids_w],
            **dst,
        )

    def _shard_batch(self, arr):
        """Pad the leading (front-batch) axis to a mesh multiple with
        identity blocks and constrain it onto the mesh.  Returns the
        PADDED array — callers slice [:n_d] after the batched dense ops.

        No-op for single-device backends and for groups with fewer
        fronts than devices (the top-of-tree sequential tail —
        replicating those costs O(top-front^3) once per factor).

        The explicit eye padding is load-bearing, not cosmetic: letting
        GSPMD shard an UNEVEN batch miscomputes here — measured on the
        8-virtual-device CPU mesh, assembled fronts came back with
        integer-valued errors exactly at shard-boundary batch entries
        (pad unit-diagonals landing in wrong slots through the
        slice+all-gather of the ragged tail).  Identity blocks keep the
        padded entries Cholesky-safe (chol(I)=I, Schur pad = 0)."""
        if not self._shards(arr.shape[0]):
            return arr
        from ..backend import DOF_AXIS

        # Pin the producer replicated BEFORE resharding: without this,
        # the batch-sharding constraint propagates BACKWARD into the
        # group's assembly/relay segment_sums and GSPMD's partitioned
        # scatter lowering miscomputes (measured: a group's own fronts
        # corrupt exactly when the group has relay inputs; leaf groups
        # shard clean).  The replicated pin keeps the scatters local and
        # makes the reshard an explicit post-assembly collective.
        arr = self._replicate(arr)
        r = (-arr.shape[0]) % self.mesh.size
        if r:
            if arr.ndim == 3 and arr.shape[1] == arr.shape[2]:
                pad = jnp.broadcast_to(
                    jnp.eye(arr.shape[1], dtype=arr.dtype),
                    (r,) + arr.shape[1:],
                )
            else:
                pad = jnp.zeros((r,) + arr.shape[1:], arr.dtype)
            arr = jnp.concatenate([arr, pad])
        spec = jax.sharding.PartitionSpec(
            DOF_AXIS, *([None] * (arr.ndim - 1))
        )
        return jax.lax.with_sharding_constraint(
            arr, jax.sharding.NamedSharding(self.mesh, spec)
        )

    def _shards(self, n):
        """Does a batch of n fronts shard over the mesh?  (Groups with
        fewer fronts than devices stay replicated — the top-of-tree
        sequential tail.  MGB_ND_SHARD_ONLY=comma-list-of-d restricts
        sharding to specific groups, a bisection debug knob.)"""
        if self.mesh is None or n < self.mesh.size:
            return False
        only = os.environ.get("MGB_ND_SHARD_ONLY")
        if only is not None and str(getattr(self, "_cur_d", "")) not in \
                only.split(","):
            return False
        return True

    def _pin_sharded(self, arr):
        """Constrain an ALREADY-EVEN batch (a _shard_batch product or a
        value computed from one) to the batch-sharded layout, without
        padding or the replicate pre-pin.  Applied to the OUTPUTS of the
        per-group dense ops: without it GSPMD's backward propagation
        from the replicated group outputs wins and the chol/tri-inv/mm
        chain runs replicated (measured: per-device HLO dots at full
        padded batch size).  Pinning both ends places the all-gather
        AFTER the O(F^3) work."""
        if self.mesh is None or arr.shape[0] < self.mesh.size:
            return arr
        from ..backend import DOF_AXIS

        spec = jax.sharding.PartitionSpec(
            DOF_AXIS, *([None] * (arr.ndim - 1))
        )
        return jax.lax.with_sharding_constraint(
            arr, jax.sharding.NamedSharding(self.mesh, spec)
        )

    def _wide_pin(self, arr, axis):
        """Constrain `arr`'s row axis onto the mesh for within-front
        sharding (see __init__).  No-op below the row threshold — tiny
        extents cost more in resharding than they distribute."""
        if arr.shape[axis] < max(2 * self.mesh.size, 64):
            return arr
        from ..backend import DOF_AXIS

        spec = [None] * arr.ndim
        spec[axis] = DOF_AXIS
        return jax.lax.with_sharding_constraint(
            arr,
            jax.sharding.NamedSharding(
                self.mesh, jax.sharding.PartitionSpec(*spec)
            ),
        )

    def _replicate(self, arr):
        """Constrain to fully replicated — applied to each group's Schur
        complement before the parent group reads it.  This is the
        distributed-multifrontal child->parent send (one all-gather per
        group); the relay gathers then index a replicated buffer, which
        keeps GSPMD's scatter/gather partitioning out of the cross-group
        traffic while the O(F^3) dense work within the group shards."""
        if self.mesh is None:
            return arr
        spec = jax.sharding.PartitionSpec(*([None] * arr.ndim))
        return jax.lax.with_sharding_constraint(
            arr, jax.sharding.NamedSharding(self.mesh, spec)
        )

    @staticmethod
    def _prec_ctx(dtype):
        """Matmul-precision context for a given factor dtype.

        A default-precision float32 dot/einsum may run in TF32 on a GPU
        (~10 mantissa bits) — an "f32" factor built that way is
        effectively a TF32 factor, and the f32pc preconditioner quality
        collapses far earlier along the barrier path than true f32 would
        (certification died at t=10 with one-pass reduced-precision f32
        matmuls vs t~1e3 with true f32).  Force true-f32 accumulation
        for f32 factor/solve traces; MGB_ND_F32_MM_PREC=default|high|
        highest overrides.  f64 traces need no context: the pair-f32
        (df) kernels pin HIGHEST on each of their own dots."""
        if dtype == jnp.float32:
            return jax.default_matmul_precision(
                os.environ.get("MGB_ND_F32_MM_PREC", "highest")
            )
        import contextlib

        return contextlib.nullcontext()

    def factor(self, vals: jnp.ndarray, consts, dtype=None, upto=None,
               base_impl=None):
        dtype_r = self.dtype if dtype is None else dtype
        with self._prec_ctx(dtype_r):
            return self._factor_impl(vals, consts, dtype_r, upto, base_impl)

    def _factor_impl(self, vals: jnp.ndarray, consts, dtype, upto=None,
                     base_impl=None):
        """vals: deduplicated segment array (HostPattern layout:
        (f1*nf+f2)*nuniq + pid).  Returns deepest-first [(Ls, Lsb)].

        `dtype` overrides the factorization precision: a float32 factor
        runs the whole batched-dense schedule at f32 rate, and the
        caller recovers f64
        direction accuracy with factor-preconditioned CG in f64
        (amgb direction(); classic mixed-precision direct solve, the
        same recipe MUMPS/cuDSS expose).  Valid while
        eps32 * cond(H) << 1 — the caller stages by barrier parameter t
        and escapes to an f64 factor when the f32 leg stops making
        Newton progress."""
        sym = self.sym
        nf = sym.nf
        vflat = vals.astype(dtype)  # flat (f1*nf+f2)*nuniq + pid layout
        Fn = [sym.s_pad[d] + sym.b_pad[d] for d in range(sym.ngroups)]
        relay = self.ea_mode == "relay"
        # children's Schur complements (dense, field-interleaved):
        # fanin keeps a flat buffer gathered by ancestor assemblies;
        # relay keeps per-group arrays consumed by the parent group only
        sb_flat = None if relay else jnp.zeros(int(sym.sb_off[-1]), dtype)
        schur_grp: dict = {}
        out = []
        for d in range(sym.ngroups - 1, -1, -1):
            self._cur_d = d  # debug hook for MGB_ND_SHARD_ONLY
            n_d = len(sym.by_depth[d])
            F = Fn[d] * nf
            s = sym.s_pad[d] * nf
            mm = _mm_native
            # factor-precision simulator: truncate this group's stage
            # outputs (and every mm product) to qbits mantissa bits
            bi = (
                (base_impl or self.base_impl)
                if dtype == jnp.float64
                else "xla"
            )
            qb = self.qbits
            if qb is not None and dtype == jnp.float64:
                qv = int(qb[d]) if isinstance(qb, (list, tuple)) else int(qb)
            else:
                qv = 53
            if qv < 53:
                qf = lambda a, _q=qv: _round_bits(a, _q)
                mm = lambda a, b, _mm=mm, _qf=qf: _qf(_mm(a, b))
            else:
                qf = lambda a: a
            # ONE segment_sum assembles everything this group needs —
            # deduplicated matrix values + child Schur contributions +
            # pad-slot unit diagonals — at DOF level, producing the
            # field-interleaved dense fronts directly (no pair-block
            # interleave/deinterleave layout passes).
            data = vflat[consts["asm_pid"][d]]
            npad = len(sym.pad_ids[d])
            nseg = n_d * F * F
            if relay:
                # base assembly: matrix values + pad unit diagonals only
                parts = [data]
                if npad:
                    parts.append(jnp.ones(npad, dtype))
                blocks = jax.ops.segment_sum(
                    jnp.concatenate(parts) if npad else data,
                    consts["asm_dst_nea"][d],
                    num_segments=nseg,
                )
                fronts = blocks.reshape(n_d, F, F)
                # stage-attribution truncations (probe only): 'asm' =
                # base scatter alone; 'ea' adds the relay traffic with
                # a FAKE Schur (front slice, so gathers/memory are real
                # but no factor math); 'chol' adds the Cholesky.
                if upto == "asm":
                    out.append((fronts[:, 0, :1], fronts[:, :1, :1]))
                    continue
                # children's Schur relayed through the parent: batch
                # gather (whole fronts), row gather (whole rows), then
                # column selection (one-hot matmul, or a
                # lane-axis gather under MGB_ND_RELAY_COLS=gather)
                for (gc, _c, _p, _r), ops in zip(
                    sym.relay_in[d], consts["relay"][d]
                ):
                    cidx_a, pkk_a, rdof = ops
                    sch = schur_grp[gc]
                    spad = jnp.pad(
                        sch[cidx_a], ((0, 0), (0, 1), (0, 1))
                    )
                    A1 = jnp.take_along_axis(
                        spad, rdof[:, :, None], axis=1
                    )
                    if self.relay_cols == "gather":
                        A2 = jnp.take_along_axis(
                            A1, rdof[:, None, :], axis=2
                        )
                    else:
                        Bf1 = spad.shape[1]
                        S = (
                            rdof[:, None, :]
                            == jnp.arange(Bf1, dtype=rdof.dtype)[
                                None, :, None
                            ]
                        ).astype(dtype)
                        A2 = A1 @ S
                    # Window guard: a segment_sum over whole (Nc, F, F)
                    # matrices emits a scatter-add whose update window is
                    # one F x F front (fem2d L=8's root depth: F=1012,
                    # 7.8MB f64), and a compiler with a small on-chip
                    # scratch budget can refuse it.  Above a window-size
                    # threshold, flatten
                    # to ROW-level segments (window = one F-row, a few
                    # KB); row ids stay sorted because pkk_a is.
                    win_mb = F * F * jnp.dtype(dtype).itemsize / 2**20
                    if win_mb > self.ea_row_mb:
                        rid = (
                            pkk_a[:, None] * F
                            + jnp.arange(F, dtype=pkk_a.dtype)[None, :]
                        ).reshape(-1)
                        add = jax.ops.segment_sum(
                            A2.reshape(-1, F), rid,
                            num_segments=n_d * F,
                            indices_are_sorted=True,
                        )
                        fronts = fronts + add.reshape(n_d, F, F)
                    else:
                        fronts = fronts + jax.ops.segment_sum(
                            A2, pkk_a, num_segments=n_d,
                            indices_are_sorted=True,
                        )
                # shard the batch only AFTER assembly + relay extend-add
                # complete: GSPMD's partitioned scatter miscomputes when
                # a segment_sum targets an already-sharded uneven batch
                # (measured: group-level dL=0.5 on the 8-virtual-device
                # CPU mesh).  The O(F^3) dense work below is where the
                # distribution pays anyway.
                fronts = self._shard_batch(fronts)
                if upto in ("ea", "chol"):
                    if upto == "chol":
                        if self.chol == "blocked" and s > self.panel:
                            Lt = _chol_blocked(fronts[:, :s, :s],
                                               base=self.panel, mm=mm,
                                               base_impl=bi)
                        elif bi == "df":
                            Lt = _df_chol(fronts[:, :s, :s], s)
                        else:
                            Lt = jnp.linalg.cholesky(fronts[:, :s, :s])
                        out.append((Lt[:, :1, :1], Lt[:, :1, :1]))
                    else:
                        out.append((fronts[:, :1, :1], fronts[:, :1, :1]))
                    if sym.b_pad[d]:
                        schur_grp[d] = fronts[:, s:, s:]
                    continue
            elif self.split_sum:
                # two scatter-adds instead of concat+one: avoids
                # materializing the gathered extend-add data (XLA can
                # fuse the sb_flat gather into the second scatter).
                # Measured SLOWER on XLA:CPU; kept as an A/B flag.
                parts = [data]
                if npad:
                    parts.append(jnp.ones(npad, dtype))
                blocks = jax.ops.segment_sum(
                    jnp.concatenate(parts) if npad else data,
                    consts["asm_dst_nea"][d],
                    num_segments=nseg,
                )
                if consts["ea_tsrc"][d].shape[0]:
                    blocks = blocks.at[consts["ea_tdst"][d]].add(
                        sb_flat[consts["ea_tsrc"][d]]
                    )
            else:
                parts = [data]
                if consts["ea_tsrc"][d].shape[0]:
                    parts.append(sb_flat[consts["ea_tsrc"][d]])
                if npad:
                    parts.append(jnp.ones(npad, dtype))
                blocks = jax.ops.segment_sum(
                    jnp.concatenate(parts) if len(parts) > 1 else parts[0],
                    consts["asm_dst"][d],
                    num_segments=nseg,
                )
            if not relay:
                fronts = self._shard_batch(blocks.reshape(n_d, F, F))
            if os.environ.get("MGB_ND_DEBUG_FRONTS") == "1":
                # debug: return raw assembled fronts instead of factors
                out.append((fronts[:n_d], fronts[:n_d, :1, :1]))
                if sym.b_pad[d]:
                    schur_grp[d] = self._replicate(
                        fronts
                    )[:n_d, s:, s:] if relay else None
                continue
            fronts = qf(fronts)
            # fronts may carry eye-padded batch entries beyond n_d (see
            # _shard_batch); the batched dense ops run on the padded
            # batch, results are sliced back before leaving the group.
            n_b = fronts.shape[0]
            sharded = self._shards(n_d)
            pin = self._pin_sharded if sharded else (lambda a: a)
            # within-front sharding for the replicated top-tree groups
            # (SCALING.md §3): row-shard the O(F^3) panel matmuls
            wide = (
                self.mesh is not None
                and self.shard_wide
                and not sharded
                and F >= self.wide_min
            )
            pinr = self._wide_pin if wide else None
            # wide groups always take the blocked kernels: XLA's fused
            # cholesky/substitution expanders cannot row-shard, the
            # panel matmuls can
            if (self.chol == "blocked" or wide) and s > self.panel:
                Ls = _chol_blocked(fronts[:, :s, :s], base=self.panel,
                                   mm=mm, base_impl=bi, pin_rows=pinr)
            elif bi == "df":
                Ls = _df_chol(fronts[:, :s, :s], s)
            else:
                Ls = jnp.linalg.cholesky(fronts[:, :s, :s])
            if wide:
                Ls = self._replicate(Ls)
            Ls = pin(qf(Ls))
            if self.use_inv:
                if (self.tri_inv == "blocked" or wide) and s > self.panel:
                    Lk = _tri_inv_blocked(Ls, base=self.panel, mm=mm,
                                          base_impl=bi, pin_rows=pinr)
                elif bi == "df":
                    Lk = _df_tri_inv(Ls, s)
                else:
                    ar = jnp.arange(s)
                    eye = (ar[:, None] == ar[None, :]).astype(dtype)
                    Lk = jax.scipy.linalg.solve_triangular(
                        Ls,
                        eye[None] * jnp.ones((n_b, 1, 1), dtype),
                        lower=True,
                    )
                if wide:
                    Lk = self._replicate(Lk)
                Lk = pin(qf(Lk))
                if wide:
                    Lsb = self._replicate(
                        qf(
                            pinr(
                                mm(pinr(Lk, 1), fronts[:, :s, s:]), 1
                            )
                        )
                    )
                else:
                    Lsb = pin(qf(mm(Lk, fronts[:, :s, s:])))
            else:
                Lk = Ls
                Lsb = pin(
                    qf(
                        jax.scipy.linalg.solve_triangular(
                            Ls, fronts[:, :s, s:], lower=True
                        )
                    )
                )
            if sharded:
                # replicate (an even all-gather) BEFORE the uneven
                # [:n_d] slice: slicing a ragged tail out of a sharded
                # batch is the exact uneven-shard corner the eye padding
                # exists to avoid
                out.append(
                    (self._replicate(Lk)[:n_d], self._replicate(Lsb)[:n_d])
                )
            else:
                out.append((Lk, Lsb))
            if sym.b_pad[d]:
                if wide:
                    upd = pinr(
                        mm(pinr(jnp.swapaxes(Lsb, -1, -2), 1), Lsb), 1
                    )
                    schur = self._replicate(qf(fronts[:, s:, s:] - upd))
                else:
                    schur = qf(
                        fronts[:, s:, s:]
                        - mm(jnp.swapaxes(Lsb, -1, -2), Lsb)
                    )
                schur = pin(schur)
                if sharded:
                    schur = self._replicate(schur)[:n_d]
                if relay:
                    # child -> parent send: replicated so the parent
                    # group's relay gathers stay local (see _replicate)
                    schur_grp[d] = (
                        schur if sharded else self._replicate(schur)
                    )
                else:
                    sb_flat = jax.lax.dynamic_update_slice(
                        sb_flat, schur.reshape(-1), (int(sym.sb_off[d]),)
                    )
        return out

    def solve(self, fac, b: jnp.ndarray, consts):
        with self._prec_ctx(fac[0][0].dtype):
            return self._solve_impl(fac, b, consts)

    def _solve_impl(self, fac, b: jnp.ndarray, consts):
        """Solve A x = b.  b: (N,) node-major global dofs
        (dof = node * nf + field)."""
        sym = self.sym
        ng = sym.ngroups
        dtype = fac[0][0].dtype  # sweeps run at the factor's precision
        # slot N is the read-only pad sink (always zero); slot N+1 is the
        # write-only pad sink (garbage, never read) — see _build_solve_maps
        bg = jnp.concatenate([b.astype(dtype), jnp.zeros(2, dtype)])
        ys = []
        for pos, d in enumerate(range(ng - 1, -1, -1)):
            Lk, Lsb = fac[pos]
            bS = bg[consts["sep_gids"][d]]
            if self.use_inv:
                yS = jnp.einsum("kab,kb->ka", Lk, bS)
            else:
                yS = jax.scipy.linalg.solve_triangular(
                    Lk, bS[:, :, None], lower=True
                )[:, :, 0]
            ys.append(yS)
            if Lsb.shape[2]:
                upd = -jnp.einsum("kab,ka->kb", Lsb, yS)
                bg = bg.at[consts["bd_gids_w"][d].reshape(-1)].add(
                    upd.reshape(-1)
                )
        xg = jnp.zeros(sym.N + 2, dtype)
        for pos in range(len(fac) - 1, -1, -1):
            d = ng - 1 - pos
            Lk, Lsb = fac[pos]
            yS = ys[pos]
            if Lsb.shape[2]:
                xB = xg[consts["bd_gids"][d]]
                yS = yS - jnp.einsum("kab,kb->ka", Lsb, xB)
            if self.use_inv:
                xS = jnp.einsum("kba,kb->ka", Lk, yS)
            else:
                xS = jax.scipy.linalg.solve_triangular(
                    Lk, yS[:, :, None], lower=True, trans=1
                )[:, :, 0]
            xg = xg.at[consts["sep_gids_w"][d].reshape(-1)].set(
                xS.reshape(-1)
            )
        return xg[: sym.N]


def node_coords(idx: np.ndarray, m: int, x: np.ndarray, nq: int) -> np.ndarray:
    """Per-node coordinates for the geometric bisection: mean of the
    element-center coordinates of the elements touching each node."""
    idx = np.asarray(idx)
    x = np.asarray(x)
    nelem, nl = idx.shape
    dim = x.shape[1]
    centers = x.reshape(nelem, nq, dim).mean(axis=1)
    acc = np.zeros((m + 1, dim))
    cnt = np.zeros(m + 1)
    np.add.at(acc, idx.reshape(-1), np.repeat(centers, nl, axis=0))
    np.add.at(cnt, idx.reshape(-1), 1.0)
    cnt[cnt == 0] = 1.0
    return (acc / cnt[:, None])[:m]
