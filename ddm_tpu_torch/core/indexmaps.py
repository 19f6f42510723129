"""Host-side domain-decomposition topology: partitions, overlap, index maps.

This module replaces, with *one-time host precomputation*, the reference's
entire distributed index machinery:

* element partitioning         <- ParMETIS via dune-grid loadBalance
                                  (examples/poisson.cc:127-134)
* dof ownership                <- lowest-rank-wins DisjointPartitioning
                                  (dune/ddm/pdelab_helper.hh:34-37)
* overlap extension            <- matrix-graph BFS + MPI rounds
                                  (dune/ddm/overlap_extension.hh:53-285)
* subdomain boundary masks     <- IdentifyBoundaryDataHandle
                                  (dune/ddm/datahandles.hh:122-192)
* boundary-distance layers     <- relaxation loops (pou.hh:100-111,
                                  examples/pdelab_helper.hh:151-158)
* partition of unity           <- PartitionOfUnity (dune/ddm/pou.hh:24-209)

The output is a set of **static, padded int32 arrays** (SURVEY.md §3.5): every
subdomain k owns a row ``sub2glob[k, :]`` of global dof ids padded to the
common width ``n_pad``.  All device-side DDM ops are pure gathers/scatters
through these maps — no communication code exists at all; XLA inserts the
collectives when the subdomain batch axis is sharded over a device mesh.

Everything here is numpy/scipy on host and runs once per (mesh, overlap).

A copy of ``ddm_tpu/core/indexmaps.py`` (framework-neutral numpy, so the
two packages build identical subdomains; tests/test_torch_core.py checks
that they do), with its g++/ctypes topology route (``_native/``): native
and scipy routes give equal arrays (tests/test_torch_native.py).
``TOPOLOGY_ROUTES`` counts the route each ``build_topology`` call took in
this process.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sps

TOPOLOGY_ROUTES = {"native": 0, "python": 0}


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------

def partition_structured(shape: tuple[int, ...], parts: tuple[int, ...]) -> np.ndarray:
    """Block-partition the elements of a structured grid (YaspGrid's PowerD
    partitioning equivalent).  shape: cells per axis; parts: subdomain grid.
    Returns (n_elems,) subdomain id, elements ordered axis-0-fastest."""
    dim = len(shape)
    assert len(parts) == dim
    idx = np.stack(
        np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), axis=0
    ).reshape(dim, -1, order="F")
    part = np.zeros(idx.shape[1], dtype=np.int64)
    stride = 1
    for d in range(dim):
        # split axis d into parts[d] nearly-equal chunks
        edges = np.floor(np.arange(1, parts[d]) * shape[d] / parts[d]).astype(int)
        coord_part = np.searchsorted(edges, idx[d], side="right")
        part += coord_part * stride
        stride *= parts[d]
    return part


def partition_rcb(centroids: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection over element centroids.

    Host-side replacement for ParMETIS graph partitioning (SURVEY.md §2.5);
    produces balanced, connected-ish parts on the meshes shipped with the
    reference.  n_parts need not be a power of two.
    """
    n = centroids.shape[0]
    part = np.zeros(n, dtype=np.int64)

    def rec(ids: np.ndarray, k: int, base: int):
        if k == 1:
            part[ids] = base
            return
        k_lo = k // 2
        pts = centroids[ids]
        spans = pts.max(axis=0) - pts.min(axis=0)
        axis = int(np.argmax(spans))
        order = np.argsort(pts[:, axis], kind="stable")
        n_lo = int(round(len(ids) * k_lo / k))
        rec(ids[order[:n_lo]], k_lo, base)
        rec(ids[order[n_lo:]], k - k_lo, base + k_lo)

    rec(np.arange(n), n_parts, 0)
    return part


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

@dataclass
class DDMTopology:
    """Static per-subdomain index maps (all host numpy).

    Padding convention: invalid slots of ``sub2glob`` hold ``n_glob``; device
    code gathers from arrays padded with one trailing zero slot.
    """

    n_glob: int
    n_sub: int
    n_pad: int
    overlap: int
    sub2glob: np.ndarray  # (n_sub, n_pad) int32, pad == n_glob
    valid: np.ndarray  # (n_sub, n_pad) bool
    owner: np.ndarray  # (n_sub, n_pad) bool — dof owned by this subdomain
    boundary: np.ndarray  # (n_sub, n_pad) bool — subdomain-boundary dofs
    bdist: np.ndarray  # (n_sub, n_pad) int32 — graph distance from boundary
    bdist_cap: int
    dof_owner: np.ndarray  # (n_glob,) int32 owning subdomain per dof
    # global->local map in sorted-key CSR form: g2l_keys holds
    # k * (n_glob + 1) + glob_id for every member dof, globally sorted;
    # g2l_locs the matching local slot.  A dense (n_sub, n_glob + 1) array
    # (the round-1..3 layout) is O(n_sub * n) — 152 MB at the 384^2/256
    # bench and ~61 GB at the 7.5M-dof/2048-subdomain HBM ceiling, with
    # O(n_pairs * n) transient blowups in the pairs map; the CSR form is
    # O(sum sizes) (~2.6 MB / ~130 MB at those scales) and lookups are one
    # vectorized searchsorted.
    g2l_keys: np.ndarray  # (nnz,) int64, sorted
    g2l_locs: np.ndarray  # (nnz,) int32
    membership: sps.csr_matrix  # (n_sub, n_glob) bool
    sizes: np.ndarray  # (n_sub,) true subdomain sizes

    def lookup(self, sub_idx, glob_ids) -> np.ndarray:
        """Vectorized global->local: local slot of dof ``glob_ids`` in
        subdomain ``sub_idx`` (broadcast together), -1 where absent.
        ``glob_ids`` may include the padding id ``n_glob``."""
        k = np.asarray(sub_idx, dtype=np.int64)
        g = np.asarray(glob_ids, dtype=np.int64)
        key = k * (self.n_glob + 1) + g
        if self.g2l_keys.size == 0:
            return np.full(key.shape, -1, dtype=np.int32)
        pos = np.searchsorted(self.g2l_keys, key)
        pos = np.minimum(pos, max(self.g2l_keys.size - 1, 0))
        hit = self.g2l_keys[pos] == key
        return np.where(hit, self.g2l_locs[pos], -1).astype(np.int32)

    def local_of(self, k: int, glob_ids: np.ndarray) -> np.ndarray:
        return self.lookup(k, glob_ids)

    @property
    def glob2loc(self) -> np.ndarray:
        """Dense (n_sub, n_glob + 1) materialization of the global->local
        map (-1 where absent).  O(n_sub * n) memory — test/debug use only;
        library code goes through :meth:`lookup`."""
        out = np.full((self.n_sub, self.n_glob + 1), -1, dtype=np.int32)
        k = self.g2l_keys // (self.n_glob + 1)
        g = self.g2l_keys % (self.n_glob + 1)
        out[k, g] = self.g2l_locs
        return out


def dof_membership_from_elems(
    elems: np.ndarray, elem_part: np.ndarray, n_glob: int, n_sub: int, n_comp: int = 1
) -> sps.csr_matrix:
    """(n_sub, n_glob) bool: dof belongs to subdomain k's *non-overlapping*
    index set iff one of k's elements touches it."""
    n_e, nd = elems.shape
    if n_comp == 1:
        dofs = elems
    else:
        dofs = (elems[:, :, None] * n_comp + np.arange(n_comp)).reshape(n_e, -1)
    rows = np.repeat(elem_part, dofs.shape[1])
    cols = dofs.reshape(-1)
    M = sps.csr_matrix(
        (np.ones(rows.size, dtype=np.int8), (rows, cols)), shape=(n_sub, n_glob)
    )
    M.data[:] = 1
    return M


def _topology_native(adj_csr, membership0, overlap, cap):
    """Native C++ route: (ids, bnd, dist) per subdomain, or None when the
    library is unavailable (``_native.load``)."""
    import ctypes

    from .._native import load

    lib = load()
    if lib is None:
        return None
    n = adj_csr.shape[0]
    n_sub = membership0.shape[0]
    indptr = np.ascontiguousarray(adj_csr.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(adj_csr.indices, dtype=np.int32)
    m0 = membership0.tocsr()
    seed_off = np.ascontiguousarray(m0.indptr, dtype=np.int64)
    seed_ids = np.ascontiguousarray(m0.indices, dtype=np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    total = lib.ddm_topology_compute(
        ptr(indptr), ptr(indices), n, ptr(seed_off), ptr(seed_ids), n_sub,
        overlap, cap, 0,
    )
    offsets = np.empty(n_sub + 1, dtype=np.int64)
    ids = np.empty(total, dtype=np.int32)
    bnd = np.empty(total, dtype=np.uint8)
    dist = np.empty(total, dtype=np.int32)
    lib.ddm_topology_collect(ptr(offsets), ptr(ids), ptr(bnd), ptr(dist))
    out = []
    for k in range(n_sub):
        s, e = offsets[k], offsets[k + 1]
        out.append((ids[s:e], bnd[s:e].astype(bool), dist[s:e]))
    return out


def build_topology(
    adj: sps.spmatrix,
    membership0: sps.csr_matrix,
    dof_owner: np.ndarray,
    overlap: int,
    pad_to: int = 8,
    use_native: bool | None = None,
) -> DDMTopology:
    """Build the overlapping-subdomain topology.

    adj: (n, n) structurally-symmetric matrix-graph adjacency (pattern of A).
    membership0: (n_sub, n) non-overlapping dof membership.
    dof_owner: (n,) owning subdomain of each dof (lowest-subdomain-wins).
    overlap: number of matrix-graph extension rounds
             (reference: overlap_extension.hh round loop).
    use_native: the C++ route (``_native/ddmcore.cpp``) when None and it
    builds (a failed build warns), always when True (raises
    ``RuntimeError`` if it is unavailable), never when False; both routes
    give equal arrays.
    """
    n = adj.shape[0]
    n_sub = membership0.shape[0]
    cap = 4 * overlap + 2

    if use_native is not False:
        Acsr = sps.csr_matrix(adj, copy=True)
        Acsr.data[:] = 1
        Acsr = ((Acsr + Acsr.T) > 0).astype(np.int8).tocsr()
        native = _topology_native(Acsr, membership0, overlap, cap)
        if native is not None:
            TOPOLOGY_ROUTES["native"] += 1
            return _pack_topology(native, dof_owner, n, n_sub, overlap, cap,
                                  pad_to)
        if use_native:
            from .._native import error

            raise RuntimeError(
                f"native ddmcore requested but unavailable: {error}")
    TOPOLOGY_ROUTES["python"] += 1
    A = sps.csr_matrix(adj, copy=True)
    A.data[:] = 1
    A = ((A + A.T + sps.eye(n, format="csr")) > 0).astype(np.int8)

    # overlap rounds: one matrix-graph layer per round
    M = (membership0 > 0).astype(np.int8).tocsr()
    for _ in range(overlap):
        M = ((M @ A) > 0).astype(np.int8).tocsr()

    # subdomain boundary: member dof with a graph neighbour outside the set
    deg = np.asarray(A.sum(axis=0)).ravel()  # includes self
    in_count = (M @ A).tocsr()  # counts of in-set neighbours (incl. self)
    Mbool = M.astype(bool)
    B = Mbool.multiply(in_count < deg[None, :]).tocsr()
    B.eliminate_zeros()  # multiply() stores explicit False entries

    # boundary distance within each subdomain (cap mirrors the reference's
    # 4*overlap relaxation rounds, pou.hh:106)
    visited = B.copy().astype(bool).tocsr()
    frontier = visited.copy()
    dist_mat = sps.csr_matrix((n_sub, n), dtype=np.int32)
    for r in range(1, cap + 1):
        nxt = ((frontier @ A) > 0).tocsr().multiply(Mbool)
        new = (nxt.astype(np.int8) - nxt.multiply(visited).astype(np.int8)) > 0
        new = sps.csr_matrix(new)
        if new.nnz == 0:
            break
        dist_mat = dist_mat + new.astype(np.int32) * r
        visited = ((visited + new) > 0).tocsr()
        frontier = new

    Mcsr = Mbool.tocsr()
    Bcsr = B.tocsr()
    Dcsr = dist_mat.tocsr()
    per_sub = []
    for k in range(n_sub):
        ids = np.sort(Mcsr.indices[Mcsr.indptr[k] : Mcsr.indptr[k + 1]])
        brow = np.zeros(n, dtype=bool)
        brow[Bcsr.indices[Bcsr.indptr[k] : Bcsr.indptr[k + 1]]] = True
        drow = np.full(n, cap, dtype=np.int32)
        drow[Dcsr.indices[Dcsr.indptr[k] : Dcsr.indptr[k + 1]]] = Dcsr.data[
            Dcsr.indptr[k] : Dcsr.indptr[k + 1]
        ]
        d = drow[ids]
        d[brow[ids]] = 0
        per_sub.append((ids, brow[ids], d))
    return _pack_topology(per_sub, dof_owner, n, n_sub, overlap, cap, pad_to)


def _pack_topology(per_sub, dof_owner, n, n_sub, overlap, cap, pad_to):
    """Pack per-subdomain (ids, boundary, dist) into padded arrays."""
    sizes = np.array([len(ids) for ids, _, _ in per_sub])
    n_pad = int(-(-sizes.max() // pad_to) * pad_to)
    sub2glob = np.full((n_sub, n_pad), n, dtype=np.int32)
    valid = np.zeros((n_sub, n_pad), dtype=bool)
    owner = np.zeros((n_sub, n_pad), dtype=bool)
    boundary = np.zeros((n_sub, n_pad), dtype=bool)
    bdist = np.full((n_sub, n_pad), cap, dtype=np.int32)
    keys, locs = [], []
    mrows, mcols = [], []
    for k, (ids, bnd, d) in enumerate(per_sub):
        sz = ids.size
        sub2glob[k, :sz] = ids
        valid[k, :sz] = True
        owner[k, :sz] = dof_owner[ids] == k
        keys.append(k * np.int64(n + 1) + ids.astype(np.int64))
        locs.append(np.arange(sz, dtype=np.int32))
        boundary[k, :sz] = bnd
        bdist[k, :sz] = np.minimum(d, cap)
        mrows.append(np.full(sz, k))
        mcols.append(ids)
    keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)
    locs = np.concatenate(locs) if locs else np.zeros(0, np.int32)
    order = np.argsort(keys)
    keys, locs = keys[order], locs[order]
    membership = sps.csr_matrix(
        (np.ones(int(sizes.sum()), dtype=bool),
         (np.concatenate(mrows), np.concatenate(mcols))),
        shape=(n_sub, n),
    )
    return DDMTopology(
        n_glob=n,
        n_sub=n_sub,
        n_pad=n_pad,
        overlap=overlap,
        sub2glob=sub2glob,
        valid=valid,
        owner=owner,
        boundary=boundary,
        bdist=bdist,
        bdist_cap=cap,
        dof_owner=dof_owner,
        g2l_keys=keys,
        g2l_locs=locs,
        membership=membership,
        sizes=sizes,
    )


def dof_owner_lowest(
    elems: np.ndarray, elem_part: np.ndarray, n_glob: int, n_comp: int = 1
) -> np.ndarray:
    """Dof ownership: the lowest subdomain id among adjacent elements wins
    (reference: DisjointPartitioningDataHandle, pdelab_helper.hh:34-37)."""
    owner = np.full(n_glob, np.iinfo(np.int32).max, dtype=np.int64)
    n_e, nd = elems.shape
    if n_comp == 1:
        dofs = elems
    else:
        dofs = (elems[:, :, None] * n_comp + np.arange(n_comp)).reshape(n_e, -1)
    for c in range(dofs.shape[1]):
        np.minimum.at(owner, dofs[:, c], elem_part)
    return owner.astype(np.int32)


# ---------------------------------------------------------------------------
# partition of unity (reference: dune/ddm/pou.hh)
# ---------------------------------------------------------------------------

def pou_weights(
    topo: DDMTopology, pou_type: str = "distance", shrink: int = 0
) -> np.ndarray:
    """Partition-of-unity weights, (n_sub, n_pad) float64.

    Types mirror pou.hh:24-28: ``trivial`` (1 on owned dofs), ``standard``
    (1 / #subdomains-sharing, 0 on subdomain boundaries), ``distance``
    (graph-distance weighting with ``shrink`` oversampling, Toselli & Widlund
    p. 84; raw weight w=dist-shrink capped like pou.hh:113-120, normalized by
    the cross-subdomain weight sum).
    """
    overlap = topo.overlap
    if pou_type == "trivial":
        return topo.owner.astype(np.float64)

    if not 0 <= shrink < max(overlap, 1):
        raise ValueError(
            f"Invalid value for shrink: {shrink} (must be >= 0 and < overlap {overlap})"
        )

    interior = topo.valid & ~topo.boundary
    if pou_type == "standard":
        count = np.zeros(topo.n_glob + 1)
        np.add.at(count, topo.sub2glob, interior.astype(np.float64))
        cnt = count[topo.sub2glob]
        w = np.where(interior & (cnt > 0), 1.0 / np.maximum(cnt, 1), 0.0)
        return w

    if pou_type == "distance":
        d = topo.bdist
        w_raw = np.where(
            d > 4 * overlap,
            1.0,
            np.where(d <= shrink, 0.0, (d - shrink).astype(np.float64)),
        )
        w_raw = np.where(topo.valid, w_raw, 0.0)
        total = np.zeros(topo.n_glob + 1)
        np.add.at(total, topo.sub2glob, w_raw)
        tot = total[topo.sub2glob]
        w = np.where(interior & (tot > 0), w_raw / np.maximum(tot, 1e-300), 0.0)
        return w

    raise ValueError(f"Unknown partition of unity type: {pou_type}")


def dual_scatter_map(topo: DDMTopology) -> np.ndarray:
    """Transposed dual of the subdomain scatter: for each global dof i, the
    flat slots j (row-major into the (n_sub, n_pad) batch) with
    ``sub2glob.flat[j] == i``, padded with ``n_sub * n_pad``.

    Returns (K, n_glob) int32, K = max dofs-per-subdomain multiplicity.
    Turns the per-iteration scatter-add (TPU scatters run element-at-a-time,
    ~30 ms at bench sizes) into a lane-friendly gather + K-term sum (~0.1 ms);
    see precond/extract.py:scatter_add_subdomain.  The (K, n) layout keeps
    the gather's minor output dimension = n (a (n, K) layout wastes >90% of
    every (8,128) vector tile and measures as slow as the scatter).
    Cached on the topology object.
    """
    cached = getattr(topo, "_dual_scatter_map", None)
    if cached is not None:
        return cached
    flat_ids = topo.sub2glob.reshape(-1).astype(np.int64)
    n = topo.n_glob
    pad = flat_ids.size
    valid = topo.valid.reshape(-1)
    flat_ids = np.where(valid, flat_ids, n)  # padding slots -> dummy dof n
    order = np.argsort(flat_ids, kind="stable")
    sorted_ids = flat_ids[order]
    counts = np.bincount(flat_ids, minlength=n + 1)[: n + 1]
    K = int(counts[:n].max()) if n else 1
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos_in = np.arange(pad) - starts[sorted_ids]
    keep = sorted_ids < n
    dual = np.full((n, K), pad, dtype=np.int32)
    dual[sorted_ids[keep], pos_in[keep]] = order[keep].astype(np.int32)
    dualT = np.ascontiguousarray(dual.T)
    object.__setattr__(topo, "_dual_scatter_map", dualT)
    return dualT


# ---------------------------------------------------------------------------
# dense-extraction map (global ELL -> batched dense subdomain matrices)
# ---------------------------------------------------------------------------

def extraction_map(topo: DDMTopology, ell_cols: np.ndarray) -> np.ndarray:
    """For each subdomain row slot (k, p) and each ELL slot j of global row
    ``sub2glob[k, p]``: the subdomain-local column index, or ``n_pad`` if the
    column is outside subdomain k (or padding).  int32 (n_sub, n_pad, m).

    Entries to outside columns being *dropped* is exactly what makes the
    extracted matrix the overlapping "Dirichlet" matrix A_dir of the
    reference (examples/pdelab_helper.hh:134-138): couplings across the
    subdomain boundary do not exist in the subdomain operator.
    """
    n = topo.n_glob
    n_pad = topo.n_pad
    rows = np.minimum(topo.sub2glob, n - 1)  # clip padding for the gather
    cols_g = ell_cols[rows]  # (n_sub, n_pad, m) global col ids (pad == n)
    cols_clip = np.minimum(cols_g, n)
    loc = topo.lookup(
        np.arange(topo.n_sub)[:, None, None], cols_clip
    )
    loc = np.where((loc < 0) | ~topo.valid[:, :, None], n_pad, loc)
    return loc.astype(np.int32)
