"""Cyclades conflict-free partitioning (host-side scheduler; the port's
copy of celeste_jl_tpu/parallel/partition.py).

Sources whose patches overlap share ELBO pixel terms and must not be
optimized concurrently within a batch. The Cyclades algorithm (partition.jl)
shuffles sources, splits them into batches, finds connected components of the
conflict graph within each batch, and schedules each component atomically —
serially equivalent to a random permutation.

The "threads" are the lanes of batched launches: each batch's components
are flattened into a padded array of source indices that one `fit_sources`
launch processes; batches run sequentially (the barrier).
"""

import numpy as np


class UnionFind:
    def __init__(self, n):
        self.parent = np.arange(n)

    def find(self, i):
        root = i
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[i] != root:      # path compression
            self.parent[i], i = root, self.parent[i]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def connected_components(nodes, neighbor_map):
    """Connected components among `nodes` (subset) of the conflict graph.

    neighbor_map: dict node -> iterable of conflicting nodes.
    Returns list of lists of nodes.
    """
    idx = {s: i for i, s in enumerate(nodes)}
    uf = UnionFind(len(nodes))
    for s in nodes:
        for nb in neighbor_map.get(s, ()):
            if nb in idx:
                uf.union(idx[s], idx[nb])
    comps = {}
    for s in nodes:
        comps.setdefault(uf.find(idx[s]), []).append(s)
    return list(comps.values())


def partition_cyclades_dynamic(target_sources, neighbor_map, batch_size=60,
                               rng=None):
    """[batch][component][source_index] partition (partition.jl:173-236).

    target_sources: list of source ids. neighbor_map: id -> conflicting ids.
    Returns components containing *indices into target_sources*.
    """
    rng = rng or np.random.default_rng(42)
    src_to_idx = {s: i for i, s in enumerate(target_sources)}
    sources = list(neighbor_map.keys())
    rng.shuffle(sources)

    n = len(sources)
    n_batches = int(np.ceil(n / batch_size)) if n else 0
    batches = []
    for bi in range(n_batches):
        chunk = sources[bi * batch_size:(bi + 1) * batch_size]
        comps = connected_components(chunk, neighbor_map)
        batches.append([[src_to_idx[s] for s in comp] for comp in comps])
    return batches


def partition_cyclades(n_threads, target_sources, neighbor_map, batch_size=60,
                       rng=None):
    """[thread][batch][sources] static assignment with greedy load balancing
    (partition.jl:85-162)."""
    dyn = partition_cyclades_dynamic(target_sources, neighbor_map,
                                     batch_size, rng)
    n_batches = len(dyn)
    assignment = [[[] for _ in range(n_batches)] for _ in range(n_threads)]
    for bi, comps in enumerate(dyn):
        loads = np.zeros(n_threads, dtype=np.int64)
        for comp in comps:
            t = int(np.argmin(loads))
            assignment[t][bi].extend(comp)
            loads[t] += len(comp)
    return assignment


def partition_equally(n_threads, n_sources):
    """[thread][batch=1][sources] equal split (partition.jl:250-273)."""
    per = n_sources // n_threads
    out = []
    for t in range(n_threads):
        start = t * per
        end = n_sources if t == n_threads - 1 else (t + 1) * per
        out.append([list(range(start, end))])
    return out


def load_balance_across_threads(n_threads, costs):
    """Greedy assignment of weighted items to threads; returns (assignment
    lists, max/mean imbalance) (ParallelRun.jl:49-56)."""
    order = np.argsort(costs)[::-1]
    loads = np.zeros(n_threads)
    assignment = [[] for _ in range(n_threads)]
    for i in order:
        t = int(np.argmin(loads))
        assignment[t].append(int(i))
        loads[t] += costs[i]
    mean = loads.mean() if len(costs) else 0.0
    imbalance = (loads.max() / mean) if mean > 0 else 1.0
    return assignment, imbalance


def choose_batch_size_auto(target_sources, neighbor_map, costs, n_threads,
                           candidates=(40, 60, 80, 120, 200), rng=None):
    """Pick the batch size minimizing simulated thread imbalance with cost =
    active-pixel count (ParallelRun.jl:63-95)."""
    best_bs, best_score = None, np.inf
    for bs in candidates:
        batches = partition_cyclades_dynamic(target_sources, neighbor_map,
                                             bs, rng or
                                             np.random.default_rng(42))
        score = 0.0
        for comps in batches:
            comp_costs = [sum(costs[i] for i in comp) for comp in comps]
            _, imb = load_balance_across_threads(n_threads, comp_costs)
            score += imb
        if score < best_score:
            best_bs, best_score = bs, score
    return best_bs
