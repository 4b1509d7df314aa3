"""P2P network topology: adjacency/Laplacian algebra, connectivity,
mixing matrices, and matching decomposition (Sec. II-A, Eq. 1, 5-6).
A numpy copy of ``repro.core.topology``, bit-exact against it.

Everything here is host-side coordinator math (numpy): topologies are
round-static control inputs.

Two representations coexist:

- dense ``[N, N]`` 0/1 adjacency matrices — the original small-W path;
- sparse ``[E, 2]`` edge arrays (undirected, each row ``i < j``) with
  per-edge mixing weights — the large-W path, where anything O(N^2)
  (dense mixing matrices, row scans) is off the table. The edge-list
  helpers (``edges_from_adj``, ``ring_edges``, ``edge_mixing_weights``,
  ``connected_components_edges``, ``UnionFind``) never materialize a
  dense matrix.
"""
from __future__ import annotations

import warnings

import numpy as np


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def full_topology(n: int) -> np.ndarray:
    """Complete graph K_n — FedHP's default base topology A^0 (the
    controller prunes links from it, Alg. 3)."""
    a = np.ones((n, n), dtype=np.int8) - np.eye(n, dtype=np.int8)
    return a


def ring_topology(n: int) -> np.ndarray:
    """Ring — the D-PSGD [12] / AD-PSGD [23] baseline topology."""
    a = np.zeros((n, n), dtype=np.int8)
    if n == 1:
        return a
    idx = np.arange(n)
    a[idx, (idx + 1) % n] = 1
    a[idx, (idx - 1) % n] = 1
    if n == 2:
        a = np.clip(a, 0, 1)
    return a


def erdos_topology(n: int, p: float, rng: np.random.Generator) -> np.ndarray:
    """Erdős–Rényi base topology, retried until connected.

    If 1000 draws never produce a connected graph (tiny ``p``), falls
    back to a ring plus seeded random chords — connected by the ring,
    with the chords recovering some of the requested edge density (a
    bare ring has the worst spectral gap of any connected topology, so
    silently returning one would sabotage low-``p`` specs). The
    fallback warns so callers can tell the spec was unsatisfiable.
    """
    for _ in range(1000):
        u = rng.random((n, n))
        a = ((u + u.T) / 2 < p).astype(np.int8)
        np.fill_diagonal(a, 0)
        if is_connected(a):
            return a
    # fall back: ring + seeded random chords
    warnings.warn(
        f"erdos_topology(n={n}, p={p}): no connected draw in 1000 tries;"
        " falling back to ring + random chords", RuntimeWarning,
        stacklevel=2)
    a = ring_topology(n)
    if n > 3:
        # aim for the requested expected edge count, minus the ring's n
        # edges; always add at least one chord so the fallback never
        # degrades to a bare ring
        target = max(1, int(round(p * n * (n - 1) / 2)) - n)
        iu, ju = np.triu_indices(n, k=1)
        free = np.nonzero(a[iu, ju] == 0)[0]
        take = min(target, free.size)
        if take > 0:
            sel = free[rng.choice(free.size, size=take, replace=False)]
            a[iu[sel], ju[sel]] = 1
            a[ju[sel], iu[sel]] = 1
    return a


def barabasi_albert_topology(n: int, m: int,
                             rng: np.random.Generator) -> np.ndarray:
    """Barabási–Albert preferential attachment: scale-free degree
    distribution, the complex-network regime where degree heterogeneity
    drives convergence as hard as compute heterogeneity (arxiv
    2312.04504). Each arriving vertex attaches ``m`` edges to existing
    vertices with probability proportional to their current degree.

    Starts from a complete core of ``m + 1`` vertices, so the graph is
    connected by construction. Requires ``1 <= m < n``.
    """
    if not 1 <= m < n:
        raise ValueError(f"barabasi_albert needs 1 <= m < n, got m={m} n={n}")
    a = np.zeros((n, n), dtype=np.int8)
    core = m + 1
    a[:core, :core] = full_topology(core)
    # repeated-nodes list: each endpoint appears once per incident edge,
    # so a uniform draw from it IS the preferential-attachment law
    targets: list[int] = [v for i in range(core) for v in (i,) * m]
    for v in range(core, n):
        chosen: set[int] = set()
        while len(chosen) < m:
            chosen.add(int(targets[int(rng.integers(0, len(targets)))]))
        for u in chosen:
            a[v, u] = a[u, v] = 1
            targets.extend((v, u))
    return a


def watts_strogatz_topology(n: int, k: int, p: float,
                            rng: np.random.Generator) -> np.ndarray:
    """Watts–Strogatz small world: ring lattice with ``k`` neighbors per
    vertex (``k/2`` each side, ``k`` even) where each lattice edge is
    rewired to a random endpoint with probability ``p`` — short path
    lengths at ring-like degree regularity.

    Rewired draws are retried until connected (100 tries); if ``p`` is
    so high the rewiring keeps disconnecting the lattice, falls back to
    the unrewired lattice (always connected) and warns, mirroring
    ``erdos_topology``'s unsatisfiable-spec behavior.
    """
    if not (2 <= k < n and k % 2 == 0):
        raise ValueError(f"watts_strogatz needs even 2 <= k < n, "
                         f"got k={k} n={n}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"rewiring probability must be in [0, 1], got {p}")
    idx = np.arange(n)
    lattice = np.zeros((n, n), dtype=np.int8)
    for off in range(1, k // 2 + 1):
        lattice[idx, (idx + off) % n] = 1
        lattice[(idx + off) % n, idx] = 1
    for _ in range(100):
        a = lattice.copy()
        for off in range(1, k // 2 + 1):
            for i in range(n):
                j = (i + off) % n
                if a[i, j] and rng.random() < p:
                    free = np.nonzero((a[i] == 0) & (idx != i))[0]
                    if free.size == 0:
                        continue
                    t = int(free[int(rng.integers(0, free.size))])
                    a[i, j] = a[j, i] = 0
                    a[i, t] = a[t, i] = 1
        if is_connected(a):
            return a
    warnings.warn(
        f"watts_strogatz_topology(n={n}, k={k}, p={p}): no connected "
        "rewiring in 100 tries; falling back to the unrewired lattice",
        RuntimeWarning, stacklevel=2)
    return lattice


def rack_assignment(n: int, racks: int) -> np.ndarray:
    """Worker -> rack map for the geographic topology and correlated
    failure schedules: ``n`` workers split into ``racks`` contiguous
    blocks (sizes differing by at most one), returned as an ``[n]``
    int64 array of rack ids."""
    if not 1 <= racks <= n:
        raise ValueError(f"need 1 <= racks <= n, got racks={racks} n={n}")
    out = np.empty(n, dtype=np.int64)
    for r, block in enumerate(np.array_split(np.arange(n), racks)):
        out[block] = r
    return out


def geo_topology(n: int, racks: int, rng: np.random.Generator) -> np.ndarray:
    """Geographic/rack-correlated topology: workers live in ``racks``
    contiguous racks (``rack_assignment``), each rack internally
    complete (cheap intra-rack links), racks joined in a ring by one
    seeded uplink each (rack ``r`` -> rack ``r+1`` between random
    members) — dense locally, sparse globally, connected by
    construction. The same rack map drives
    ``ChurnSchedule.generate_correlated`` outages, so a rack failure
    takes out exactly one dense neighborhood."""
    assign = rack_assignment(n, racks)
    a = np.zeros((n, n), dtype=np.int8)
    same = assign[:, None] == assign[None, :]
    a[same] = 1
    np.fill_diagonal(a, 0)
    if racks > 1:
        for r in range(racks):
            src = np.nonzero(assign == r)[0]
            dst = np.nonzero(assign == (r + 1) % racks)[0]
            i = int(src[int(rng.integers(0, src.size))])
            j = int(dst[int(rng.integers(0, dst.size))])
            a[i, j] = a[j, i] = 1
    return a


def make_base_topology(n: int, spec: str, seed: int = 0) -> np.ndarray:
    """Parse a base-topology spec string.

    Forms: ``full`` | ``ring`` | ``erdos:<p>`` | ``ba:<m>`` |
    ``ws:<k>:<p>`` | ``geo:<racks>`` (see README's spec-string table).
    All families pass ``validate_topology`` and convert to the sparse
    engine's edge lists via ``edges_from_adj`` unchanged.
    """
    if spec == "full":
        return full_topology(n)
    if spec == "ring":
        return ring_topology(n)
    if spec.startswith("erdos:"):
        p = float(spec.split(":", 1)[1])
        return erdos_topology(n, p, np.random.default_rng(seed))
    if spec.startswith("ba:"):
        m = int(spec.split(":", 1)[1])
        return barabasi_albert_topology(n, m, np.random.default_rng(seed))
    if spec.startswith("ws:"):
        _, k, p = spec.split(":", 2)
        return watts_strogatz_topology(n, int(k), float(p),
                                       np.random.default_rng(seed))
    if spec.startswith("geo:"):
        racks = int(spec.split(":", 1)[1])
        return geo_topology(n, racks, np.random.default_rng(seed))
    raise ValueError(f"unknown topology spec {spec!r}")


# ---------------------------------------------------------------------------
# Spectral / connectivity (Eq. 1; Assumption 4)
# ---------------------------------------------------------------------------

def laplacian(adj: np.ndarray) -> np.ndarray:
    """Graph Laplacian L = D - A (Eq. 1; spectral connectivity input)."""
    adj = np.asarray(adj, dtype=np.float64)
    return np.diag(adj.sum(axis=1)) - adj


def algebraic_connectivity(adj: np.ndarray) -> float:
    """lambda_2 of the Laplacian; > 0 iff the graph is connected."""
    n = adj.shape[0]
    if n == 1:
        return 1.0  # single vertex: trivially "connected"
    vals = np.linalg.eigvalsh(laplacian(adj))
    return float(vals[1])


def is_connected(adj: np.ndarray) -> bool:
    """BFS connectivity (cheaper and exact vs eigenvalue tolerance)."""
    n = adj.shape[0]
    if n <= 1:
        return True
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        i = stack.pop()
        for j in np.nonzero(adj[i])[0]:
            if not seen[j]:
                seen[j] = True
                stack.append(int(j))
    return bool(seen.all())


def connected_components(adj: np.ndarray,
                         nodes: np.ndarray | None = None) -> list[np.ndarray]:
    """Connected components of the subgraph induced by ``nodes`` (default:
    all vertices). Returns a list of index arrays."""
    n = adj.shape[0]
    nodes = np.arange(n) if nodes is None else np.asarray(nodes)
    in_sub = np.zeros(n, bool)
    in_sub[nodes] = True
    seen = np.zeros(n, bool)
    comps: list[np.ndarray] = []
    for start in nodes:
        if seen[start]:
            continue
        stack = [int(start)]
        seen[start] = True
        comp = [int(start)]
        while stack:
            i = stack.pop()
            for j in np.nonzero(adj[i])[0]:
                if in_sub[j] and not seen[j]:
                    seen[j] = True
                    comp.append(int(j))
                    stack.append(int(j))
        comps.append(np.array(sorted(comp)))
    return comps


class UnionFind:
    """Disjoint-set forest with path compression + union by size.

    The workhorse behind the edge-list connectivity helpers and
    ``repair_connectivity``: component queries in near-O(1) without ever
    scanning dense adjacency rows.
    """

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)
        self.count = n                      # number of disjoint sets

    def find(self, i: int) -> int:
        """Root of ``i``'s set (with path compression)."""
        p = self.parent
        root = i
        while p[root] != root:
            root = p[root]
        while p[i] != root:                 # compress
            p[i], i = root, p[i]
        return int(root)

    def union(self, i: int, j: int) -> bool:
        """Merge the sets of ``i`` and ``j``; True if they were disjoint."""
        ri, rj = self.find(i), self.find(j)
        if ri == rj:
            return False
        if self.size[ri] < self.size[rj]:
            ri, rj = rj, ri
        self.parent[rj] = ri
        self.size[ri] += self.size[rj]
        self.count -= 1
        return True


# ---------------------------------------------------------------------------
# Edge-list representation (sparse gossip path; no dense row scans)
# ---------------------------------------------------------------------------

def edges_from_adj(adj: np.ndarray) -> np.ndarray:
    """Dense adjacency -> ``[E, 2]`` int32 undirected edge array, each
    row ``i < j``, sorted row-major (the boundary op between the dense
    planner output and the sparse engine)."""
    i, j = np.nonzero(np.triu(np.asarray(adj), k=1))
    return np.stack([i, j], axis=1).astype(np.int32)


def adj_from_edges(edges: np.ndarray, n: int) -> np.ndarray:
    """``[E, 2]`` edge array -> dense int8 adjacency (small-W parity and
    validation only; defeats the point at large W)."""
    a = np.zeros((n, n), dtype=np.int8)
    e = np.asarray(edges).reshape(-1, 2)
    if e.size:
        a[e[:, 0], e[:, 1]] = 1
        a[e[:, 1], e[:, 0]] = 1
    return a


def ring_edges(n: int) -> np.ndarray:
    """Ring topology directly as an ``[n, 2]`` edge array (no dense
    [n, n] intermediate) — the D-PSGD baseline at large W."""
    if n <= 1:
        return np.zeros((0, 2), dtype=np.int32)
    if n == 2:
        return np.array([[0, 1]], dtype=np.int32)
    idx = np.arange(n - 1, dtype=np.int32)
    chain = np.stack([idx, idx + 1], axis=1)
    return np.concatenate([np.array([[0, n - 1]], np.int32), chain])


def degrees_from_edges(edges: np.ndarray, n: int) -> np.ndarray:
    """Vertex degrees of an ``[E, 2]`` edge array via bincount (O(E))."""
    e = np.asarray(edges).reshape(-1, 2)
    return np.bincount(e.reshape(-1), minlength=n).astype(np.int64)


def mask_edges(edges: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """Drop edges touching dead workers (the edge-list analogue of
    zeroing dead rows/columns of the adjacency)."""
    e = np.asarray(edges).reshape(-1, 2)
    alive = np.asarray(alive, bool)
    keep = alive[e[:, 0]] & alive[e[:, 1]]
    return e[keep]


def edge_mixing_weights(edges: np.ndarray, n: int,
                        mixing: str = "uniform") -> np.ndarray:
    """Per-edge mixing weight ``w_e = W[i, j]`` from degrees alone, in
    O(E) — bit-identical to the off-diagonal entries of the dense
    ``mixing_matrix_uniform`` (Eq. 6) / ``mixing_matrix_metropolis``
    matrices, without building them. Self-weights are implicit: the
    sparse update ``y_i = x_i + sum_e w_e (x_j - x_i)`` already encodes
    ``W_ii = 1 - sum_j W_ij``.
    """
    e = np.asarray(edges).reshape(-1, 2)
    if e.shape[0] == 0:
        return np.zeros((0,), np.float64)
    deg = degrees_from_edges(e, n)
    if mixing == "uniform":
        u_max = deg.max()
        return np.full(e.shape[0], 1.0 / (u_max + 1.0))
    if mixing == "metropolis":
        return 1.0 / (1.0 + np.maximum(deg[e[:, 0]], deg[e[:, 1]]))
    raise ValueError(f"unknown mixing {mixing!r}")


def directed_edges(edges: np.ndarray,
                   weights: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """Undirected ``[E, 2]`` + weights -> directed ``(src, dst, w)``
    arrays of length 2E (both orientations), the device-side gossip
    format: ``y[dst] += w * (x[src] - x[dst])``."""
    e = np.asarray(edges).reshape(-1, 2).astype(np.int32)
    w = np.asarray(weights, np.float32).reshape(-1)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    return src, dst, np.concatenate([w, w])


def connected_components_edges(edges: np.ndarray, n: int,
                               nodes: np.ndarray | None = None
                               ) -> list[np.ndarray]:
    """Connected components from an edge array via union-find — O(E α)
    instead of the dense BFS's O(N^2) row scans. Matches
    ``connected_components``: components ordered by smallest member,
    members sorted."""
    nodes = np.arange(n) if nodes is None else np.asarray(nodes)
    in_sub = np.zeros(n, bool)
    in_sub[nodes] = True
    uf = UnionFind(n)
    for i, j in mask_edges(edges, in_sub):
        uf.union(int(i), int(j))
    groups: dict[int, list[int]] = {}
    for v in sorted(int(x) for x in nodes):
        groups.setdefault(uf.find(v), []).append(v)
    return [np.array(g) for g in groups.values()]


def is_connected_edges(edges: np.ndarray, n: int) -> bool:
    """Edge-array connectivity check (union-find; O(E α))."""
    if n <= 1:
        return True
    uf = UnionFind(n)
    for i, j in np.asarray(edges).reshape(-1, 2):
        uf.union(int(i), int(j))
    return uf.count == 1


def repair_connectivity(adj: np.ndarray, alive: np.ndarray | None = None,
                        cost: np.ndarray | None = None) -> np.ndarray:
    """Cheapest-reconnect pass (churn tolerance): if the alive-induced
    subgraph is disconnected, greedily add the GLOBAL min-cost
    cross-component edge until one component remains — true Kruskal
    over the component graph, so the added edges form a minimum-cost
    spanning forest of the components (ties broken row-major on the
    live-index grid, keeping the repair a pure function of its inputs).

    Components are tracked with a union-find instead of re-running BFS
    after every added edge; candidate costs live in one live x live
    matrix whose intra-component entries are masked as the merges
    happen, so the whole repair is O(L^2) after the initial component
    pass rather than O(C L^2) BFS re-scans.

    ``cost`` is an (N,N) link-time matrix (e.g. beta); unit costs when
    None. Dead rows/columns are zeroed in the result. Returns a new array.
    """
    adj = np.array(adj, copy=True)
    n = adj.shape[0]
    alive = np.ones(n, bool) if alive is None else np.asarray(alive, bool)
    dead = np.nonzero(~alive)[0]
    adj[dead, :] = 0
    adj[:, dead] = 0
    live = np.nonzero(alive)[0]
    nl = len(live)
    if nl <= 1:
        return adj
    uf = UnionFind(nl)                       # over live-local indices
    loc = np.full(n, -1, np.int64)
    loc[live] = np.arange(nl)
    li, lj = np.nonzero(np.triu(adj[np.ix_(live, live)], k=1))
    for a, b in zip(li, lj):
        uf.union(int(a), int(b))
    if uf.count == 1:
        return adj
    if cost is None:
        sub = np.ones((nl, nl))
    else:
        sub = np.asarray(cost, np.float64)[np.ix_(live, live)].copy()
    # mask intra-component candidates (incl. the diagonal) once
    members: dict[int, list[int]] = {}
    for v in range(nl):
        members.setdefault(uf.find(v), []).append(v)
    for g in members.values():
        sub[np.ix_(g, g)] = np.inf
    while uf.count > 1:
        k = int(np.argmin(sub))              # first flat min: deterministic
        a, b = divmod(k, nl)
        adj[live[a], live[b]] = adj[live[b], live[a]] = 1
        ra, rb = uf.find(a), uf.find(b)
        ga, gb = members.pop(ra), members.pop(rb)
        sub[np.ix_(ga, gb)] = np.inf
        sub[np.ix_(gb, ga)] = np.inf
        uf.union(a, b)
        members[uf.find(a)] = ga + gb
    return adj


# ---------------------------------------------------------------------------
# Mixing matrices (Eq. 5-6; Assumption 4)
# ---------------------------------------------------------------------------

def mixing_matrix_uniform(adj: np.ndarray) -> np.ndarray:
    """Paper's Eq. (6): w_ij = 1/(u_max+1); symmetric doubly stochastic."""
    adj = np.asarray(adj, dtype=np.float64)
    n = adj.shape[0]
    if n == 1:
        return np.ones((1, 1))
    u_max = adj.sum(axis=1).max()
    w = adj / (u_max + 1.0)
    np.fill_diagonal(w, 0.0)
    w += np.diag(1.0 - w.sum(axis=1))
    return w


def mixing_matrix_metropolis(adj: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings weights: w_ij = 1/(1+max(d_i,d_j)).

    Beyond-paper option: strictly better spectral gap than Eq. (6) on
    irregular graphs while remaining symmetric doubly stochastic and
    requiring only neighbor-degree knowledge.
    """
    adj = np.asarray(adj, dtype=np.float64)
    n = adj.shape[0]
    if n == 1:
        return np.ones((1, 1))
    deg = adj.sum(axis=1)
    # vectorized degree broadcast: at W=2048 the old per-edge Python loop
    # dominated replan time for irregular (BA/geo) graphs
    w = np.where(adj > 0, 1.0 / (1.0 + np.maximum.outer(deg, deg)), 0.0)
    w += np.diag(1.0 - w.sum(axis=1))
    return w


def spectral_gap_rho(w: np.ndarray) -> float:
    """rho = max(|lambda_2|, |lambda_N|) of the mixing matrix (Assumption 4)."""
    n = w.shape[0]
    if n == 1:
        return 0.0
    vals = np.sort(np.linalg.eigvalsh((w + w.T) / 2))
    return float(max(abs(vals[0]), abs(vals[-2])))


# ---------------------------------------------------------------------------
# Matching decomposition (TPU gossip: one collective-permute per matching)
# ---------------------------------------------------------------------------

def matching_decomposition(adj: np.ndarray) -> list[list[tuple[int, int]]]:
    """Greedy edge-coloring of the topology into matchings.

    Each matching is a set of vertex-disjoint undirected edges; on TPU a
    matching executes as ONE `lax.ppermute` whose permutation swaps each
    edge's endpoints (an involution). Vizing guarantees <= Delta+1 matchings;
    the greedy bound is 2*Delta-1, in practice ~Delta for our graphs.
    """
    n = adj.shape[0]
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if adj[i, j]]
    # sort by degree-sum so high-degree vertices get colored first
    deg = adj.sum(axis=1)
    edges.sort(key=lambda e: -(deg[e[0]] + deg[e[1]]))
    matchings: list[list[tuple[int, int]]] = []
    used: list[set[int]] = []
    for (i, j) in edges:
        for m, u in zip(matchings, used):
            if i not in u and j not in u:
                m.append((i, j))
                u.update((i, j))
                break
        else:
            matchings.append([(i, j)])
            used.append({i, j})
    return matchings


def matchings_to_perms(matchings: list[list[tuple[int, int]]],
                       n: int) -> np.ndarray:
    """(M, N) permutation table: perm[m, i] = partner of i in matching m
    (or i itself if unmatched). Each row is an involution."""
    perms = np.tile(np.arange(n), (len(matchings), 1))
    for m, match in enumerate(matchings):
        for (i, j) in match:
            perms[m, i] = j
            perms[m, j] = i
    return perms


def validate_topology(adj: np.ndarray) -> None:
    """Reject adjacency matrices that break the Sec. II-A graph model:
    must be square, symmetric (undirected), 0/1 and self-loop-free."""
    adj = np.asarray(adj)
    if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"adjacency must be square, got {adj.shape}")
    if not np.array_equal(adj, adj.T):
        raise ValueError("adjacency must be symmetric (undirected graph)")
    if np.any(np.diag(adj) != 0):
        raise ValueError("no self loops allowed")
    if not np.isin(adj, (0, 1)).all():
        raise ValueError("adjacency entries must be 0/1")
