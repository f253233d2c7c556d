"""Affinity-graph partitioning for crop-instance merging.

The port's own copy of ``cropnerf_tpu/counting/graph.py``: its code is
held equal by tests/test_torch_copies.py, so that both packages read
and write the same artifacts.

Equivalent of ``get_component`` + the vendored weighted asynchronous
label-propagation in the reference
(the reference's crop_nerf/segmentation/merger.py:26-74, lpa.py:55-100).
Three partition modes over the subcluster affinity matrix:

  * ``clique``  — iteratively remove maximal cliques (binarised affinity);
  * ``bridge``  — remove bridge edges, then connected components;
  * ``community`` — weighted asynchronous label propagation (Raghavan et
    al. 2007), reimplemented from the paper's update rule.

Graphs have <= nsub nodes per supercluster, so plain networkx is fine here
(the reference used it too).
"""
from __future__ import annotations

import random
from collections import defaultdict
from typing import List, Tuple

import numpy as np


def asyn_lpa_communities(G, weight: str = "weight", seed: int | None = None
                         ) -> List[set]:
    """Weighted asynchronous label propagation: each node repeatedly adopts
    the label with maximum total edge weight among its neighbours; stop when
    every node holds one of its maximum-frequency labels."""
    rng = random.Random(seed)
    labels = {n: i for i, n in enumerate(G)}
    changed = True
    while changed:
        changed = False
        order = list(G)
        rng.shuffle(order)
        for node in order:
            if not G[node]:
                continue
            freq = defaultdict(float)
            for _, nbr, w in G.edges(node, data=weight, default=1):
                freq[labels[nbr]] += w
            max_freq = max(freq.values())
            if max_freq > 0:
                best = [l for l, f in freq.items() if f == max_freq]
            else:
                best = [labels[node]]
            if labels[node] not in best:
                labels[node] = rng.choice(best)
                changed = True
    groups = defaultdict(set)
    for n, l in labels.items():
        groups[l].add(n)
    return list(groups.values())


def partition(affinity: np.ndarray, algo: str = "clique",
              seed: int | None = 0) -> Tuple[int, np.ndarray]:
    """Partition nodes of the (signed) affinity matrix into instances.

    Returns (num_components, labels [N]); for ``bridge``, singleton
    components get label 0 and do not count (merger.py:53-56).
    """
    import networkx as nx
    n = affinity.shape[0]
    labels = np.zeros(n)
    if algo in ("clique", "bridge"):
        adj = np.where(affinity > 0, 1, 0)
    else:
        adj = affinity
    G = nx.from_numpy_array(adj)

    components: List = []
    next_label = 1
    if algo == "clique":
        while G.order() > 0:
            clique = max(nx.find_cliques(G), key=len)
            components.append(clique)
            G.remove_nodes_from(clique)
            labels[clique] = next_label
            next_label += 1
    elif algo == "bridge":
        for comp in list(nx.connected_components(G)):
            g = G.subgraph(comp).copy()
            if len(g) > 2:
                for e in list(nx.bridges(g)):
                    g.remove_edge(*e)
            for c in nx.connected_components(g):
                if len(c) == 1:
                    labels[list(c)] = 0
                    continue
                components.append(c)
                labels[list(c)] = next_label
                next_label += 1
    elif algo == "community":
        for c in asyn_lpa_communities(G, weight="weight", seed=seed):
            c = list(c)
            components.append(c)
            labels[c] = next_label
            next_label += 1
    else:
        raise ValueError(f"unknown partition algo {algo!r}")
    return len(components), labels
