# Copy of src/repro/core/topology.py, kept verbatim so the port imports nothing of the
# JAX package; tests/test_torch_planners.py pins identical tables.
"""Communication topologies and weight matrices for R-FAST.

R-FAST communicates over two digraphs induced by weight matrices:

* ``W`` — **row-stochastic** (pull / consensus graph ``G(W)``).  Node ``i``
  pulls ``v_j`` from in-neighbours ``j`` with ``W[i, j] > 0``.
* ``A`` — **column-stochastic** (push / gradient-tracking graph ``G(A)``).
  Node ``i`` pushes scaled ``z`` mass to out-neighbours ``j`` with
  ``A[j, i] > 0``.

Assumption 1: positive diagonals, nonzero entries bounded below.
Assumption 2: ``G(W)`` and ``G(A)^T`` each contain a spanning tree, and at
least one pair of spanning trees shares a common root.

The convention throughout: an edge ``(j, i)`` means *j sends to i*; in
matrix form ``M[i, j] > 0``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

__all__ = [
    "Topology",
    "binary_tree",
    "line",
    "directed_ring",
    "exponential",
    "mesh2d",
    "parameter_server",
    "robust_tree",
    "undirected_ring",
    "validate_weights",
    "spanning_tree_roots",
    "spanning_tree_roots_dense",
    "common_roots",
    "subgraph_topology",
    "bfs_tree_topology",
    "epoch_topology",
    "TOPOLOGIES",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A pair of weight matrices + metadata describing the comm graphs.

    ``active`` (optional, default all-true) marks the member node set of
    a *dynamic-membership epoch*: inactive nodes are isolated (identity
    row of W / column of A — they neither send nor receive), and the
    Assumption 1/2 checks plus :meth:`roots` apply to the active
    submatrix only.  All execution engines keep the full ``n``-row state
    layout regardless, so epochs of one run share shapes.
    """

    name: str
    n: int
    W: np.ndarray  # (n, n) row-stochastic, pull graph
    A: np.ndarray  # (n, n) column-stochastic, push graph
    active: np.ndarray | None = None   # (n,) bool; None = all active

    # ------------------------------------------------------------------ #
    def __post_init__(self) -> None:
        if self.active is None:
            validate_weights(self.W, self.A)
            return
        # np.array (not asarray): own the mask — callers may keep
        # mutating the array they passed in (epoch timeline sweeps)
        act = np.array(self.active, dtype=bool)
        if act.shape != (self.n,):
            raise ValueError(f"active mask must have shape ({self.n},)")
        if not act.any():
            raise ValueError("a topology epoch needs at least one "
                             "active node")
        object.__setattr__(self, "active", act)
        idx = np.nonzero(act)[0]
        off = np.nonzero(~act)[0]
        sub = np.ix_(idx, idx)
        if (np.any(self.W[np.ix_(off, idx)] > 0)
                or np.any(self.W[np.ix_(idx, off)] > 0)
                or np.any(self.A[np.ix_(off, idx)] > 0)
                or np.any(self.A[np.ix_(idx, off)] > 0)):
            raise ValueError("inactive nodes must be isolated "
                             "(no weight to or from an active node)")
        validate_weights(self.W[sub], self.A[sub])

    def active_mask(self) -> np.ndarray:
        """(n,) bool membership mask (all-true when ``active`` is None)."""
        if self.active is None:
            return np.ones(self.n, dtype=bool)
        return np.asarray(self.active, dtype=bool)

    # -- edge sets (excluding self-loops) ------------------------------- #
    def edges_W(self) -> list[tuple[int, int]]:
        """Edges (j, i): j sends v to i over G(W)."""
        return [(j, i) for i in range(self.n) for j in range(self.n)
                if i != j and self.W[i, j] > 0]

    def edges_A(self) -> list[tuple[int, int]]:
        """Edges (j, i): j pushes rho to i over G(A)."""
        return [(j, i) for i in range(self.n) for j in range(self.n)
                if i != j and self.A[i, j] > 0]

    def in_neighbors_W(self, i: int) -> list[int]:
        return [j for j in range(self.n) if j != i and self.W[i, j] > 0]

    def in_neighbors_A(self, i: int) -> list[int]:
        return [j for j in range(self.n) if j != i and self.A[i, j] > 0]

    def out_neighbors_W(self, i: int) -> list[int]:
        return [j for j in range(self.n) if j != i and self.W[j, i] > 0]

    def out_neighbors_A(self, i: int) -> list[int]:
        return [j for j in range(self.n) if j != i and self.A[j, i] > 0]

    def roots(self) -> list[int]:
        """Common roots R = R_W ∩ R_{A^T} (Assumption 2), restricted to
        the active submatrix for membership epochs (global node ids)."""
        if self.active is None:
            return common_roots(self.W, self.A)
        idx = np.nonzero(self.active)[0]
        sub = np.ix_(idx, idx)
        return [int(idx[r]) for r in common_roots(self.W[sub], self.A[sub])]

    @property
    def common_roots(self) -> list[int]:
        """Alias for :meth:`roots` (the Assumption-2 root set)."""
        return self.roots()

    @property
    def max_in_degree(self) -> int:
        deg_w = max(len(self.in_neighbors_W(i)) for i in range(self.n))
        deg_a = max(len(self.in_neighbors_A(i)) for i in range(self.n))
        return max(deg_w, deg_a)


# ---------------------------------------------------------------------- #
# validation helpers
# ---------------------------------------------------------------------- #
def validate_weights(W: np.ndarray, A: np.ndarray, atol: float = 1e-8) -> None:
    """Assumption 1 + 2 checks.  Raises ValueError on violation."""
    n = W.shape[0]
    if W.shape != (n, n) or A.shape != (n, n):
        raise ValueError("W and A must be square with matching size")
    if np.any(W < 0) or np.any(A < 0):
        raise ValueError("weights must be non-negative")
    if np.any(np.diag(W) <= 0) or np.any(np.diag(A) <= 0):
        raise ValueError("Assumption 1(i): diagonals must be positive")
    if not np.allclose(W.sum(axis=1), 1.0, atol=atol):
        raise ValueError("Assumption 1(ii): W must be row-stochastic")
    if not np.allclose(A.sum(axis=0), 1.0, atol=atol):
        raise ValueError("Assumption 1(ii): A must be column-stochastic")
    if not common_roots(W, A):
        raise ValueError("Assumption 2: G(W) and G(A^T) must share a root")


def _reachable_from(adj: np.ndarray, root: int) -> set[int]:
    """Nodes reachable from ``root`` following edges adj[i, j]>0 : j -> i."""
    n = adj.shape[0]
    seen = {root}
    stack = [root]
    while stack:
        u = stack.pop()
        for v in range(n):
            # u -> v exists iff adj[v, u] > 0
            if adj[v, u] > 0 and v not in seen:
                seen.add(v)
                stack.append(v)
    return seen


def spanning_tree_roots_dense(M: np.ndarray) -> list[int]:
    """Brute-force oracle: one dense O(n²) reachability scan per candidate
    root, O(n³) total.  Kept purely as the reference
    :func:`spanning_tree_roots` is pinned against in tests."""
    n = M.shape[0]
    return [r for r in range(n) if len(_reachable_from(M, r)) == n]


def _adjacency(M: np.ndarray) -> list[np.ndarray]:
    """Out-adjacency lists of G(M): ``adj[u]`` = successors of ``u``
    (edge u -> v iff ``M[v, u] > 0``), self-loops dropped."""
    nz_i, nz_j = np.nonzero(M > 0)
    keep = nz_i != nz_j
    nz_i, nz_j = nz_i[keep], nz_j[keep]          # edge nz_j -> nz_i
    order = np.argsort(nz_j, kind="stable")
    nz_i, nz_j = nz_i[order], nz_j[order]
    bounds = np.searchsorted(nz_j, np.arange(M.shape[0] + 1))
    return [nz_i[bounds[u]:bounds[u + 1]] for u in range(M.shape[0])]


def _bfs_mask(adj: list[np.ndarray], start: int) -> np.ndarray:
    """Boolean reachable-set of one BFS over adjacency lists (O(V+E))."""
    n = len(adj)
    seen = np.zeros(n, dtype=bool)
    seen[start] = True
    frontier = [start]
    while frontier:
        u = frontier.pop()
        for v in adj[u]:
            if not seen[v]:
                seen[v] = True
                frontier.append(int(v))
    return seen


def spanning_tree_roots(M: np.ndarray) -> list[int]:
    """Roots r such that every node is reachable from r in G(M).

    ``G(M)`` has edge j -> i iff ``M[i, j] > 0`` (information flows j to i).

    One adjacency-list pass instead of the old per-candidate dense scan
    (O(n³)): the vertex finishing last in a full DFS sweep lies in a
    source SCC of the condensation, so it is the only possible root
    candidate — one forward BFS verifies it reaches everything, and the
    root set is then exactly its SCC, recovered by one backward BFS
    (every root reaches the candidate and vice versa).  Total cost:
    O(n²) adjacency build + three O(V+E) traversals, which keeps
    per-epoch re-election cheap at n ≥ 255.
    """
    n = M.shape[0]
    if n == 0:
        return []
    if n == 1:
        return [0]
    adj = _adjacency(M)

    # iterative DFS sweep over all vertices; record the global finish order
    visited = np.zeros(n, dtype=bool)
    last_finished = 0
    for s in range(n):
        if visited[s]:
            continue
        visited[s] = True
        stack: list[tuple[int, int]] = [(s, 0)]
        while stack:
            u, ptr = stack[-1]
            nxt = adj[u]
            while ptr < len(nxt) and visited[nxt[ptr]]:
                ptr += 1
            if ptr < len(nxt):
                v = int(nxt[ptr])
                stack[-1] = (u, ptr + 1)
                visited[v] = True
                stack.append((v, 0))
            else:
                stack.pop()
                last_finished = u

    cand = int(last_finished)
    if not _bfs_mask(adj, cand).all():
        return []                      # no vertex reaches everything
    # roots = SCC(cand): reach-to-cand ∩ reach-from-cand = reach-to-cand
    radj = _adjacency(M.T)             # reversed edges
    return [int(r) for r in np.nonzero(_bfs_mask(radj, cand))[0]]


def common_roots(W: np.ndarray, A: np.ndarray) -> list[int]:
    """R = R_W ∩ R_{A^T}: roots of spanning trees of G(W) and G(A^T)."""
    r_w = set(spanning_tree_roots(W))
    # G(A^T) has edge j->i iff A^T[i,j] = A[j,i] > 0, i.e. reversed push graph
    r_at = set(spanning_tree_roots(A.T))
    return sorted(r_w & r_at)


# ---------------------------------------------------------------------- #
# dynamic membership: restriction, re-election, tree rebuild
# ---------------------------------------------------------------------- #
def subgraph_topology(topo: Topology, active: np.ndarray,
                      name: str | None = None) -> Topology:
    """Restrict ``topo`` to the ``active`` node set, renormalizing.

    Weights to/from inactive nodes are dropped; every active row of W
    (column of A) is renormalized over its surviving support — the
    positive diagonal guarantees a nonzero normalizer, so Assumption 1
    survives restriction by construction.  Inactive nodes become
    isolated identity rows/columns so the full ``n``-shape state layout
    is preserved.  Raises ``ValueError`` when the restricted graphs lose
    Assumption 2 (no surviving common root) — the caller then falls back
    to a rebuild (:func:`bfs_tree_topology` via :func:`epoch_topology`).
    """
    act = np.asarray(active, dtype=bool)
    W = np.where(np.outer(act, act), topo.W, 0.0)
    A = np.where(np.outer(act, act), topo.A, 0.0)
    off = np.nonzero(~act)[0]
    W[off, off] = 1.0
    A[off, off] = 1.0
    W = W / W.sum(axis=1, keepdims=True)
    A = A / A.sum(axis=0, keepdims=True)
    return Topology(name or f"{topo.name}|sub{int(act.sum())}",
                    topo.n, W, A, active=act)


def bfs_tree_topology(topo: Topology, active: np.ndarray, root: int,
                      name: str | None = None) -> Topology:
    """Rebuild W/A spanning trees around ``root`` over the *undirected
    skeleton* of ``topo`` (the union of W- and A-edges in either
    direction) restricted to ``active``.

    This is the paper's Fig.-1 construction re-run at epoch time: a BFS
    tree from the elected root, G(W) oriented root → leaves (each node
    pulls from its parent) and G(A) reversed (each node pushes to its
    parent), so G(A^T) equals G(W) and ``root`` is the common root.
    Raises ``ValueError`` when the skeleton does not connect the active
    set — Assumption 2 is then unrecoverable for this membership.
    """
    act = np.asarray(active, dtype=bool)
    n = topo.n
    if not act[root]:
        raise ValueError(f"re-election root {root} is not active")
    skel = ((topo.W > 0) | (topo.W.T > 0)
            | (topo.A > 0) | (topo.A.T > 0)) & np.outer(act, act)
    np.fill_diagonal(skel, False)
    parent = np.full(n, -1, dtype=np.int64)
    seen = np.zeros(n, dtype=bool)
    seen[root] = True
    frontier = [root]
    while frontier:
        u = frontier.pop(0)
        for v in np.nonzero(skel[:, u] | skel[u, :])[0]:
            if not seen[v]:
                seen[v] = True
                parent[v] = u
                frontier.append(int(v))
    if not np.array_equal(seen, act):
        stranded = sorted(np.nonzero(act & ~seen)[0].tolist())
        raise ValueError(
            f"Assumption 2 unrecoverable: active nodes {stranded} are "
            f"disconnected from root {root} in the surviving skeleton")
    in_w: dict[int, list[int]] = {}
    out_a: dict[int, list[int]] = {}
    for i in np.nonzero(parent >= 0)[0]:
        in_w[int(i)] = [int(parent[i])]    # i pulls v from its parent
        out_a[int(i)] = [int(parent[i])]   # i pushes rho to its parent
    W = _row_stochastic_from_in_edges(n, in_w)
    A = _col_stochastic_from_out_edges(n, out_a)
    return Topology(name or f"{topo.name}|retree@{root}", n, W, A,
                    active=act)


def epoch_topology(topo: Topology, active: np.ndarray,
                   prefer: int | None = None,
                   name: str | None = None) -> Topology:
    """The per-epoch topology for membership set ``active``: restriction
    when Assumption 2 survives it, else root re-election + tree rebuild.

    The re-election rule (DESIGN.md §11): first try the renormalized
    restriction of the original W/A — if ``common_roots`` of the
    surviving subgraph is non-empty, the restriction IS the epoch
    topology (``prefer``, typically the previous root, wins when it is
    still a common root; otherwise the smallest surviving common root
    is the new root, but the weights need no rebuild).  Only when the
    restriction loses Assumption 2 entirely are the two trees rebuilt
    around a newly elected root via :func:`bfs_tree_topology` —
    ``prefer`` if active, else the smallest active node id.  Raises
    ``ValueError`` when the surviving skeleton is disconnected.
    """
    act = np.asarray(active, dtype=bool)
    try:
        return subgraph_topology(topo, act, name=name)
    except ValueError:
        pass
    root = (int(prefer) if prefer is not None and act[prefer]
            else int(np.nonzero(act)[0][0]))
    return bfs_tree_topology(topo, act, root, name=name)


# ---------------------------------------------------------------------- #
# weight-matrix builders
# ---------------------------------------------------------------------- #
def _row_stochastic_from_in_edges(n: int, in_edges: dict[int, list[int]]) -> np.ndarray:
    """Uniform row-stochastic W given each node's in-neighbour list."""
    W = np.zeros((n, n))
    for i in range(n):
        nbrs = sorted(set(in_edges.get(i, [])) - {i})
        w = 1.0 / (len(nbrs) + 1)
        W[i, i] = w
        for j in nbrs:
            W[i, j] = w
    return W


def _col_stochastic_from_out_edges(n: int, out_edges: dict[int, list[int]]) -> np.ndarray:
    """Uniform column-stochastic A given each node's out-neighbour list."""
    A = np.zeros((n, n))
    for i in range(n):
        nbrs = sorted(set(out_edges.get(i, [])) - {i})
        a = 1.0 / (len(nbrs) + 1)
        A[i, i] = a
        for j in nbrs:
            A[j, i] = a
    return A


def _tree_topology(name: str, n: int, parent: list[int | None]) -> Topology:
    """Build (W, A) from a rooted tree given parent pointers.

    G(W) = tree oriented root -> leaves (each node pulls from its parent).
    G(A) = reversed tree (each node pushes to its parent), so G(A^T) equals
    G(W) and the tree root is the common root (Fig. 1 construction).
    """
    in_w: dict[int, list[int]] = {}
    out_a: dict[int, list[int]] = {}
    for i, p in enumerate(parent):
        if p is None:
            continue
        in_w.setdefault(i, []).append(p)   # i pulls v from parent
        out_a.setdefault(i, []).append(p)  # i pushes rho to parent
    W = _row_stochastic_from_in_edges(n, in_w)
    A = _col_stochastic_from_out_edges(n, out_a)
    return Topology(name, n, W, A)


def _checked_builder(fn: Callable[..., Topology]) -> Callable[..., Topology]:
    """Wrap a topology builder so every constructed graph is re-validated
    (Assumption 1 weight structure + Assumption 2 common root) and any
    violation is reported with the *builder's* name, not just the matrix
    row that tripped.  ``Topology.__post_init__`` already validates, but a
    bare "W must be row-stochastic" from deep inside a sweep over eight
    builders is unattributable; this pins the blame."""
    import functools

    @functools.wraps(fn)
    def build(n: int, *args, **kwargs) -> Topology:
        try:
            topo = fn(n, *args, **kwargs)
            validate_weights(topo.W, topo.A)
        except ValueError as e:
            raise ValueError(
                f"topology builder {fn.__name__!r} (n={n}) produced an "
                f"invalid graph: {e}") from e
        if not topo.roots():
            raise ValueError(
                f"topology builder {fn.__name__!r} (n={n}) violates "
                "Assumption 2: G(W) and G(A^T) share no common root")
        return topo

    return build


@_checked_builder
def binary_tree(n: int) -> Topology:
    """Complete-ish binary tree rooted at node 0 (Fig. 3a)."""
    parent: list[int | None] = [None] + [(i - 1) // 2 for i in range(1, n)]
    return _tree_topology(f"binary_tree_{n}", n, parent)


@_checked_builder
def robust_tree(n: int) -> Topology:
    """Binary tree + bidirectional sibling rungs, sole common root 0.

    The ``root_failover`` topology: like :func:`binary_tree`, every node
    pulls v from its parent (W) and pushes ρ to it (A), so node 0 is the
    ONLY common root — but each sibling pair (1,2), (3,4), … is also
    linked both ways in both graphs.  A plain tree physically
    disconnects when the root dies; here the rung between 0's children
    keeps the surviving skeleton connected, so when 0 crashes the
    restricted subgraph still satisfies Assumption 2 with common roots
    {1, 2} and an epochized run can re-elect instead of stalling.
    """
    parent: list[int | None] = [None] + [(i - 1) // 2 for i in range(1, n)]
    in_w: dict[int, list[int]] = {}
    out_a: dict[int, list[int]] = {}
    for i, p in enumerate(parent):
        if p is not None:
            in_w.setdefault(i, []).append(p)
            out_a.setdefault(i, []).append(p)
    for i in range(1, n - 1, 2):        # sibling pairs (1,2), (3,4), ...
        for a, b in ((i, i + 1), (i + 1, i)):
            in_w.setdefault(a, []).append(b)
            out_a.setdefault(a, []).append(b)
    W = _row_stochastic_from_in_edges(n, in_w)
    A = _col_stochastic_from_out_edges(n, out_a)
    return Topology(f"robust_tree_{n}", n, W, A)


@_checked_builder
def line(n: int) -> Topology:
    """Line graph 0 - 1 - ... - n-1 rooted at 0 (Fig. 3c)."""
    parent: list[int | None] = [None] + list(range(n - 1))
    return _tree_topology(f"line_{n}", n, parent)


@_checked_builder
def parameter_server(n: int, n_servers: int = 1) -> Topology:
    """Star / PS structure: servers 0..n_servers-1 as common roots."""
    in_w: dict[int, list[int]] = {}
    out_a: dict[int, list[int]] = {}
    servers = list(range(n_servers))
    # servers form a ring among themselves (if >1) and broadcast to workers
    for s in servers:
        if n_servers > 1:
            in_w.setdefault(s, []).append(servers[(s - 1) % n_servers])
            out_a.setdefault(s, []).append(servers[(s + 1) % n_servers])
    for wk in range(n_servers, n):
        s = servers[wk % n_servers]
        in_w.setdefault(wk, []).append(s)   # worker pulls model from server
        out_a.setdefault(wk, []).append(s)  # worker pushes grads to server
    W = _row_stochastic_from_in_edges(n, in_w)
    A = _col_stochastic_from_out_edges(n, out_a)
    return Topology(f"ps_{n}_{n_servers}", n, W, A)


@_checked_builder
def directed_ring(n: int) -> Topology:
    """Directed ring i -> i+1 (mod n) for both graphs (Fig. 3b)."""
    in_edges = {i: [(i - 1) % n] for i in range(n)}
    out_edges = {i: [(i + 1) % n] for i in range(n)}
    W = _row_stochastic_from_in_edges(n, in_edges)
    A = _col_stochastic_from_out_edges(n, out_edges)
    return Topology(f"directed_ring_{n}", n, W, A)


@_checked_builder
def undirected_ring(n: int) -> Topology:
    """Symmetric ring (both directions) — used by D-PSGD/AD-PSGD baselines."""
    in_edges = {i: [(i - 1) % n, (i + 1) % n] for i in range(n)}
    W = _row_stochastic_from_in_edges(n, in_edges)
    A = _col_stochastic_from_out_edges(n, in_edges)
    return Topology(f"undirected_ring_{n}", n, W, A)


@_checked_builder
def exponential(n: int) -> Topology:
    """Directed exponential graph: i -> (i + 2^k) mod n."""
    hops = [2 ** k for k in range(max(1, int(np.ceil(np.log2(n)))))]
    in_edges = {i: sorted({(i - h) % n for h in hops} - {i}) for i in range(n)}
    out_edges = {i: sorted({(i + h) % n for h in hops} - {i}) for i in range(n)}
    W = _row_stochastic_from_in_edges(n, in_edges)
    A = _col_stochastic_from_out_edges(n, out_edges)
    return Topology(f"exponential_{n}", n, W, A)


@_checked_builder
def mesh2d(n: int) -> Topology:
    """2-D grid (4-neighbour, undirected) topology."""
    rows = int(np.floor(np.sqrt(n)))
    while n % rows:
        rows -= 1
    cols = n // rows
    def nid(r: int, c: int) -> int:
        return r * cols + c
    in_edges: dict[int, list[int]] = {i: [] for i in range(n)}
    for r in range(rows):
        for c in range(cols):
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                rr, cc = r + dr, c + dc
                if 0 <= rr < rows and 0 <= cc < cols:
                    in_edges[nid(r, c)].append(nid(rr, cc))
    W = _row_stochastic_from_in_edges(n, in_edges)
    A = _col_stochastic_from_out_edges(n, in_edges)
    return Topology(f"mesh2d_{n}", n, W, A)


TOPOLOGIES: dict[str, Callable[[int], Topology]] = {
    "binary_tree": binary_tree,
    "line": line,
    "directed_ring": directed_ring,
    "undirected_ring": undirected_ring,
    "exponential": exponential,
    "mesh2d": mesh2d,
    "parameter_server": parameter_server,
    "robust_tree": robust_tree,
}


def get_topology(name: str, n: int) -> Topology:
    if name not in TOPOLOGIES:
        raise KeyError(f"unknown topology {name!r}; have {sorted(TOPOLOGIES)}")
    return TOPOLOGIES[name](n)
