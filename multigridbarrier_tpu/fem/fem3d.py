"""fem3d — 3D hexahedral Q_k FEM hierarchy (reference:
fem3d(T; L, k, K) with Q_k elements, default k=3,
/root/reference/src/MultiGridBarrierMPI.jl:680-687; 3D problem defaults
D = [u:id, u:dx, u:dy, u:dz, s:id], src:736-738).

Design: spectral-element collocation.  The broken points of
each hexahedron are the tensor-product Gauss-Lobatto-Legendre (GLL) nodes
of order k — simultaneously a positive quadrature rule (exact through
degree 2k-1) and a unisolvent nodal set for Q_k, so differential
operators are dense (k+1)^3 x (k+1)^3 blocks applied as batched
matmuls, and the conforming-subspace inclusion is element-local
(runtime/elements.py).

Elements are parallelepipeds (affine images of the reference cube):
the default coarse mesh is the cube [-1,1]^3 and refinement is uniform
8-way splitting, which preserves parallelepipeds.  A custom coarse mesh K
is accepted as a (8*nh, 3) matrix, 8 corner rows per hexahedron in
binary (i,j,k) order, each hex affine.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import jax.numpy as jnp

from ..backend import Backend, backend_cpu
from ..runtime import BlockDiagOp, ell_from_scipy, level_basis_from_csr
from .geometry import Discretization, Geometry, pad_elements


def gll_nodes_weights(k: int):
    """Gauss-Lobatto-Legendre nodes/weights on [-1, 1], k+1 points."""
    if k == 1:
        return np.array([-1.0, 1.0]), np.array([1.0, 1.0])
    # interior nodes: roots of P'_k
    Pk = np.polynomial.legendre.Legendre.basis(k)
    interior = Pk.deriv().roots()
    x = np.concatenate([[-1.0], np.sort(interior), [1.0]])
    Pk_x = np.polynomial.legendre.legval(x, [0] * k + [1])
    w = 2.0 / (k * (k + 1) * Pk_x ** 2)
    return x, w


def lagrange_eval(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Values of the Lagrange basis on `nodes` at points `x`: (len(x), len(nodes))."""
    n = len(nodes)
    out = np.ones((len(x), n))
    for j in range(n):
        for i in range(n):
            if i != j:
                out[:, j] *= (x - nodes[i]) / (nodes[j] - nodes[i])
    return out


def lagrange_diff(nodes: np.ndarray) -> np.ndarray:
    """1D differentiation matrix D[a, b] = l_b'(node_a)."""
    n = len(nodes)
    # barycentric weights
    wb = np.ones(n)
    for j in range(n):
        for i in range(n):
            if i != j:
                wb[j] /= nodes[j] - nodes[i]
    D = np.zeros((n, n))
    for a in range(n):
        for b in range(n):
            if a != b:
                D[a, b] = (wb[b] / wb[a]) / (nodes[a] - nodes[b])
        D[a, a] = -np.sum(D[a, :])
    return D


class _HexMesh:
    """Parallelepiped mesh: verts (nv, 3), hexes (nh, 8) corner ids in
    binary (i, j, k) order (bit 0 = x, bit 1 = y, bit 2 = z)."""

    def __init__(self, verts: np.ndarray, hexes: np.ndarray):
        self.verts = verts
        self.hexes = hexes

    @property
    def nh(self) -> int:
        return len(self.hexes)

    def corners(self) -> np.ndarray:
        return self.verts[self.hexes]  # (nh, 8, 3)

    def affine(self):
        """v0 (nh,3) and edge matrix A (nh,3,3): x = v0 + A @ [u,v,w] for
        reference coords in [0,1]^3 (columns = x/y/z edge vectors)."""
        c = self.corners()
        v0 = c[:, 0]
        A = np.stack([c[:, 1] - v0, c[:, 2] - v0, c[:, 4] - v0], axis=2)
        return v0, A

    def refined(self) -> "_HexMesh":
        """Uniform 8-way refinement; children of hex h occupy 8h..8h+7 in
        binary (i,j,k) child order."""
        v0, A = self.affine()
        # lattice of 27 points per hex at u,v,w in {0, .5, 1}
        g = np.array([0.0, 0.5, 1.0])
        U, V, W = np.meshgrid(g, g, g, indexing="ij")  # index (iu, iv, iw)
        ref = np.stack([U.ravel(), V.ravel(), W.ravel()], axis=1)  # (27, 3)
        pts = v0[:, None, :] + np.einsum("hij,pj->hpi", A, ref)  # (nh, 27, 3)
        flat = pts.reshape(-1, 3)
        key = np.round(flat, 12)
        verts, inv = np.unique(key, axis=0, return_inverse=True)
        lid = lambda iu, iv, iw: iu * 9 + iv * 3 + iw  # noqa: E731
        children = []
        for h in range(self.nh):
            base = h * 27
            for cw in range(2):
                for cv in range(2):
                    for cu in range(2):
                        ids = [
                            inv[base + lid(cu + bu, cv + bv, cw + bw)]
                            for bw in range(2)
                            for bv in range(2)
                            for bu in range(2)
                        ]
                        children.append(ids)
        # reorder: children appended in (cw, cv, cu) loops -> child index
        # cu + 2*cv + 4*cw requires per-hex reorder
        children = np.asarray(children, dtype=np.int64).reshape(self.nh, 8, 8)
        order = np.empty(8, dtype=np.int64)
        i = 0
        for cw in range(2):
            for cv in range(2):
                for cu in range(2):
                    order[cu + 2 * cv + 4 * cw] = i
                    i += 1
        children = children[:, order, :].reshape(self.nh * 8, 8)
        return _HexMesh(verts, children)

    def boundary_faces(self):
        """List of (hex id, face axis, side) for faces on the boundary.
        Face key = sorted 4 corner ids."""
        faces = {}
        face_corner_ids = {}
        for axis in range(3):
            bit = 1 << axis
            for side in (0, 1):
                ids = [
                    c for c in range(8) if ((c >> axis) & 1) == side
                ]
                face_corner_ids[(axis, side)] = ids
        for h, hx in enumerate(self.hexes):
            for (axis, side), ids in face_corner_ids.items():
                key = tuple(sorted(hx[i] for i in ids))
                faces.setdefault(key, []).append((h, axis, side))
        return [v[0] for v in faces.values() if len(v) == 1]


def _default_coarse() -> _HexMesh:
    g = np.array([-1.0, 1.0])
    verts = np.array(
        [[g[i], g[j], g[kk]] for kk in range(2) for j in range(2) for i in range(2)]
    )
    return _HexMesh(verts, np.arange(8, dtype=np.int64)[None, :])


def _mesh_from_K(K) -> _HexMesh:
    K = np.asarray(K, dtype=np.float64)
    if K.ndim != 2 or K.shape[0] % 8 or K.shape[1] != 3:
        raise ValueError("K must be a (8*nh, 3) hexahedron corner matrix")
    verts, inv = np.unique(K.round(12), axis=0, return_inverse=True)
    return _HexMesh(verts, inv.reshape(-1, 8))


def _qk_node_coords(mesh: _HexMesh, gll01: np.ndarray):
    """Global Q_k node coordinates/(per-hex local->global map) via
    coordinate hashing.  Returns (coords (nn,3), hex_nodes (nh, (k+1)^3),
    boundary mask (nn,))."""
    kp1 = len(gll01)
    U, V, W = np.meshgrid(gll01, gll01, gll01, indexing="ij")
    # local node order: x fastest (iu), then iv, then iw
    ref = np.stack(
        [U.transpose(2, 1, 0).ravel(), V.transpose(2, 1, 0).ravel(), W.transpose(2, 1, 0).ravel()],
        axis=1,
    )
    # transpose so that index = iu + kp1*iv + kp1^2*iw
    v0, A = mesh.affine()
    pts = v0[:, None, :] + np.einsum("hij,pj->hpi", A, ref)
    flat = pts.reshape(-1, 3)
    key = np.round(flat, 12)
    coords, inv = np.unique(key, axis=0, return_inverse=True)
    hex_nodes = inv.reshape(mesh.nh, kp1 ** 3)

    mask = np.zeros(len(coords), dtype=bool)
    for (h, axis, side) in mesh.boundary_faces():
        sel = np.arange(kp1 ** 3)
        comp = (sel // kp1 ** axis) % kp1
        on_face = comp == (0 if side == 0 else kp1 - 1)
        mask[hex_nodes[h][on_face]] = True
    return coords, hex_nodes, mask


def fem3d(L: int = 2, k: int = 3, K=None, backend: Backend | None = None) -> Geometry:
    """Build the 3D multigrid FEM geometry (reference: MultiGridBarrier.fem3d,
    called at /root/reference/src/MultiGridBarrierMPI.jl:680-687)."""
    if backend is None:
        backend = backend_cpu()
    dt = np.float64

    gll, glw = gll_nodes_weights(k)
    gll01 = 0.5 * (gll + 1.0)  # reference coords in [0,1]
    glw01 = 0.5 * glw
    kp1 = k + 1
    nq = kp1 ** 3
    D1 = lagrange_diff(gll01)  # d/du on [0,1] nodes

    meshes = [_default_coarse() if K is None else _mesh_from_K(K)]
    for _ in range(L - 1):
        meshes.append(meshes[-1].refined())
    fine = meshes[-1]
    nh = fine.nh
    n = nh * nq

    # broken points and weights
    v0, A = fine.affine()
    U, V, W = np.meshgrid(gll01, gll01, gll01, indexing="ij")
    ref = np.stack(
        [U.transpose(2, 1, 0).ravel(), V.transpose(2, 1, 0).ravel(), W.transpose(2, 1, 0).ravel()],
        axis=1,
    )  # (nq, 3), iu fastest
    xq = v0[:, None, :] + np.einsum("hij,pj->hpi", A, ref)
    x = xq.reshape(n, 3)
    detA = np.abs(np.linalg.det(A))
    wu = glw01
    w3 = (
        wu[None, None, :] * wu[None, :, None] * wu[:, None, None]
    ).ravel()  # (nq,), index iw*kp1^2 + iv*kp1 + iu  -> matches iu-fastest
    w = (detA[:, None] * w3[None, :]).reshape(n)

    # derivative blocks: d/dx_i = sum_j invA[j,i] * Dref_j
    invA = np.linalg.inv(A)  # (nh, 3, 3)
    I = np.eye(kp1)
    # local index = iu + kp1*iv + kp1^2*iw  => kron order (w, v, u)
    Dref = [
        np.kron(np.kron(I, I), D1),  # d/du
        np.kron(np.kron(I, D1), I),  # d/dv
        np.kron(np.kron(D1, I), I),  # d/dw
    ]
    dblocks = []
    for i in range(3):
        blk = sum(
            invA[:, j, i][:, None, None] * Dref[j][None, :, :] for j in range(3)
        )
        dblocks.append(blk)

    # conforming Q_k subspaces per level, evaluated at finest broken points
    sub_full, sub_dir, interiors, level_nodes = [], [], [], []
    for lev, mesh in enumerate(meshes):
        coords, hex_nodes, bmask = _qk_node_coords(mesh, gll01)
        level_nodes.append((coords, hex_nodes, bmask))
        anc = np.arange(nh) // (8 ** (L - 1 - lev))
        # reference coords of finest points inside ancestor hex
        av0, aA = mesh.affine()
        rel = x.reshape(nh, nq, 3) - av0[anc][:, None, :]
        ref_c = np.einsum(
            "hij,hpj->hpi", np.linalg.inv(aA)[anc], rel
        )  # (nh, nq, 3) in [0,1]
        bu = lagrange_eval(gll01, ref_c[:, :, 0].ravel()).reshape(nh, nq, kp1)
        bv = lagrange_eval(gll01, ref_c[:, :, 1].ravel()).reshape(nh, nq, kp1)
        bw = lagrange_eval(gll01, ref_c[:, :, 2].ravel()).reshape(nh, nq, kp1)
        # basis value of local node (iu,iv,iw) at point p
        vals = np.einsum("hpu,hpv,hpw->hpwvu", bu, bv, bw).reshape(
            nh, nq, nq
        )  # local index iu + kp1*iv + kp1^2*iw  (w slowest)
        rows = np.repeat(np.arange(n), nq)
        cols = hex_nodes[anc][:, None, :].repeat(nq, axis=1).reshape(-1)
        R = sp.csr_matrix(
            (vals.reshape(-1), (rows, cols)), shape=(n, len(coords))
        )
        R.sum_duplicates()
        R.eliminate_zeros()
        sub_full.append(R)
        interior = ~bmask
        interiors.append(interior)
        sub_dir.append(R[:, interior])

    # inter-level embeddings: coarse Q_k basis at fine Q_k node coords
    emb_full, emb_dir = [], []
    for lev in range(L - 1):
        coarse_mesh = meshes[lev]
        fcoords, fhex_nodes, _ = level_nodes[lev + 1]
        ccoords, chex_nodes, _ = level_nodes[lev]
        # owner fine hex of each fine node -> ancestor coarse hex
        owner = np.empty(len(fcoords), dtype=np.int64)
        owner[fhex_nodes.reshape(-1)] = np.repeat(
            np.arange(meshes[lev + 1].nh), kp1 ** 3
        )
        anc = owner // 8
        cv0, cA = coarse_mesh.affine()
        rel = fcoords - cv0[anc]
        ref_c = np.einsum("nij,nj->ni", np.linalg.inv(cA)[anc], rel)
        bu = lagrange_eval(gll01, ref_c[:, 0])
        bv = lagrange_eval(gll01, ref_c[:, 1])
        bw = lagrange_eval(gll01, ref_c[:, 2])
        vals = np.einsum("nu,nv,nw->nwvu", bu, bv, bw).reshape(
            len(fcoords), kp1 ** 3
        )
        rows = np.repeat(np.arange(len(fcoords)), kp1 ** 3)
        cols = chex_nodes[anc].reshape(-1)
        E = sp.csr_matrix(
            (vals.reshape(-1), (rows, cols)),
            shape=(len(fcoords), len(ccoords)),
        )
        E.sum_duplicates()
        E.eliminate_zeros()
        emb_full.append(E)
        emb_dir.append(E[interiors[lev + 1], :][:, interiors[lev]])

    # broken-space level transfers: evaluate coarse element polynomial at
    # child points (refine); weighted L2 projection back (coarsen)
    refine_ops, coarsen_ops = [], []
    # child points in coarse reference coords: 8 children x nq points
    child_ref = []
    for cw in range(2):
        for cv in range(2):
            for cu in range(2):
                child_ref.append(0.5 * ref + 0.5 * np.array([cu, cv, cw]))
    child_ref = np.concatenate(
        [child_ref[i] for i in range(8)], axis=0
    )  # (8*nq, 3) in child order cu+2cv+4cw
    bu = lagrange_eval(gll01, child_ref[:, 0])
    bv = lagrange_eval(gll01, child_ref[:, 1])
    bw = lagrange_eval(gll01, child_ref[:, 2])
    basis_c = np.einsum("pu,pv,pw->pwvu", bu, bv, bw).reshape(8 * nq, nq)
    for lev in range(L - 1):
        nhc = meshes[lev].nh
        Rf = sp.block_diag([sp.csr_matrix(basis_c)] * nhc, format="csr")
        refine_ops.append(Rf)
        # coarsen: (B' W B)^-1 B' W with W = child quadrature weights
        Wd = np.concatenate([w3 / 8.0] * 8)
        G = basis_c.T @ (basis_c * Wd[:, None])
        M = np.linalg.solve(G, basis_c.T * Wd[None, :])
        coarsen_ops.append(
            sp.block_diag([sp.csr_matrix(M)] * nhc, format="csr")
        )

    to_ell = lambda A_: ell_from_scipy(  # noqa: E731
        A_, dtype=np.dtype(backend.dtype), itype=np.dtype(backend.itype)
    )
    to_lb = lambda R: level_basis_from_csr(  # noqa: E731
        R, nq, dtype=np.dtype(backend.dtype), itype=np.dtype(backend.itype)
    )

    geometry = Geometry(
        discretization=Discretization(
            name="fem3d",
            dim=3,
            L=L,
            nelem=nh,
            nq=nq,
            payload={"k": k, "verts": fine.verts, "hexes": fine.hexes},
        ),
        x=jnp.asarray(x, dtype=backend.dtype),
        w=jnp.asarray(w, dtype=backend.dtype),
        operators={
            "id": BlockDiagOp.identity(nh, nq, backend.dtype),
            "dx": BlockDiagOp.from_blocks(jnp.asarray(dblocks[0], dtype=backend.dtype)),
            "dy": BlockDiagOp.from_blocks(jnp.asarray(dblocks[1], dtype=backend.dtype)),
            "dz": BlockDiagOp.from_blocks(jnp.asarray(dblocks[2], dtype=backend.dtype)),
        },
        subspaces={
            "full": tuple(to_ell(R) for R in sub_full),
            "dirichlet": tuple(to_ell(R) for R in sub_dir),
        },
        refine=tuple(to_ell(R) for R in refine_ops),
        coarsen=tuple(to_ell(R) for R in coarsen_ops),
        embed={
            "full": tuple(to_ell(E) for E in emb_full),
            "dirichlet": tuple(to_ell(E) for E in emb_dir),
        },
        backend=backend,
        bases={
            "full": tuple(to_lb(R) for R in sub_full),
            "dirichlet": tuple(to_lb(R) for R in sub_dir),
        },
    )
    return pad_elements(geometry, backend.pad_multiple())
