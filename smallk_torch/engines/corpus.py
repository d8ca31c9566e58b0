"""Synthetic term-document corpus generator with realistic text statistics.

The reference benchmarks run on real corpora (reuters.mtx 12411 x 7984,
news20.mtx 39727 x 11237 — sphinx/source/pages_tests.rst:38,229) that are
unavailable offline, and rank-2 convergence rates are strongly
data-dependent: structureless uniform noise needs ~10x the iterations of a
real tf-idf term-doc matrix.  This generator reproduces the statistics that
drive solver behavior so benchmark numbers are comparable to the
reference's published wall-clocks:

  - Zipf (power-law) term document-frequencies: a shared background
    distribution plus per-cluster topic boosts on disjoint term subsets.
  - Log-normal document lengths (distinct terms per doc), matching the
    heavy-tailed nnz/column profile of preprocessed corpora.
  - tf-idf weighting + unit-L2 columns, exactly what the reference
    preprocessor emits (preprocessor/src/preprocess.cpp:193-205), which is
    what nmf/hierclust consume downstream.
  - Hierarchically-nested clusters: cluster topic vectors are leaves of a
    random binary merge tree, so recursive rank-2 splits (HierNMF2) find
    genuine structure at every level, as on real news corpora.

Returns scipy CSC plus ground-truth labels (usable for NMI/F1 scoring,
engines/scoring.py).

The port's own copy of smallk_tpu/engines/corpus.py, byte-equal in what it
returns and writes.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def synthetic_term_doc_corpus(
    m: int = 12411,
    n: int = 7984,
    n_clusters: int = 16,
    seed: int = 0,
    mean_doc_len: float = 80.0,
    topic_terms_frac: float = 0.35,
    topic_weight: float = 0.7,
    zipf_s: float = 1.1,
    dtype=np.float32,
):
    """Generate (A, labels): A an m x n tf-idf'd unit-column CSC matrix.

    `topic_weight` is the probability a drawn term comes from the
    document's cluster topic (vs the shared background); 0.7 gives
    split-priority and convergence behavior comparable to reuters
    (roughly 10-200 rank-2 iterations per node at tol 1e-4).
    """
    rng = np.random.RandomState(seed)

    # background Zipf over the whole vocabulary, random term order
    ranks = rng.permutation(m) + 1.0
    p_bg = 1.0 / ranks**zipf_s
    p_bg /= p_bg.sum()

    # hierarchical cluster topics: leaves of a random binary merge tree.
    # Each internal node owns a term subset; a leaf's topic distribution
    # boosts the subsets of all its ancestors, so sibling leaves share
    # mid-tree vocabulary — the nesting HierNMF2 exploits.
    n_topic_terms = int(topic_terms_frac * m)
    topic_term_pool = rng.choice(m, n_topic_terms, replace=False)

    # binary tree over clusters: recursively halve the cluster id range
    def build(lo, hi, terms):
        """Assign each tree node a third of its term budget; split the
        rest between children."""
        node_cut = max(1, len(terms) // 3) if hi - lo > 1 else len(terms)
        own, rest = terms[:node_cut], terms[node_cut:]
        out = [(range(lo, hi), own)]
        if hi - lo > 1:
            mid = (lo + hi) // 2
            half = len(rest) // 2
            out += build(lo, mid, rest[:half])
            out += build(mid, hi, rest[half:])
        return out

    node_terms = build(0, n_clusters, topic_term_pool)

    # per-cluster topic distribution: Zipf within each owned subset
    topic_p = np.zeros((n_clusters, m))
    for members, terms in node_terms:
        if len(terms) == 0:
            continue
        w = 1.0 / (np.arange(len(terms)) + 1.0) ** zipf_s
        for c in members:
            topic_p[c, terms] += w / w.sum()
    row_sums = topic_p.sum(axis=1, keepdims=True)
    row_sums[row_sums == 0.0] = 1.0
    topic_p /= row_sums

    labels = rng.randint(0, n_clusters, n)
    doc_lens = np.clip(
        rng.lognormal(np.log(mean_doc_len), 0.6, n), 5, 5 * mean_doc_len
    ).astype(np.int64)

    rows_parts, cols_parts, vals_parts = [], [], []
    # vectorized over clusters: draw all docs of a cluster at once
    for c in range(n_clusters):
        docs = np.where(labels == c)[0]
        if len(docs) == 0:
            continue
        mix = (1.0 - topic_weight) * p_bg + topic_weight * topic_p[c]
        total = int(doc_lens[docs].sum())
        draws = rng.choice(m, total, p=mix)  # with replacement: counts>1 ok
        cols = np.repeat(docs, doc_lens[docs])
        rows_parts.append(draws)
        cols_parts.append(cols)
        vals_parts.append(np.ones(total))

    A = sp.csc_matrix(
        (
            np.concatenate(vals_parts),
            (np.concatenate(rows_parts), np.concatenate(cols_parts)),
        ),
        shape=(m, n),
    )
    A.sum_duplicates()

    # tf-idf + unit-L2 columns (reference preprocess.cpp:193-205)
    df = np.asarray((A > 0).sum(axis=1)).ravel()
    df[df == 0] = 1
    idf = np.log(n / df)
    A.data = (1.0 + np.log(A.data)) * idf[A.indices]
    norms = np.sqrt(np.asarray(A.multiply(A).sum(axis=0))).ravel()
    norms[norms == 0.0] = 1.0
    A = A @ sp.diags(1.0 / norms)
    return A.astype(dtype).tocsc(), labels


def planted_partition_graph(
    nodes: int,
    n_communities: int,
    intra_edges_per_node: int = 20,
    inter_edges_per_node: int = 2,
    seed: int = 7,
):
    """Generate (adjacency, labels): a symmetric 0/1 planted-partition
    graph — the dblp15-style community-recovery workload (BASELINE
    config 3; the reference treats graph clustering as hierclust on a
    generic sparse matrix, README.md:9-27).

    Each node draws ~intra_edges_per_node endpoints inside its community
    and the whole graph adds inter_edges_per_node*nodes random noise
    edges; the result is symmetrized and binarized.  Used by both
    bench.py (NMI metric) and scripts/tpu_smoke.py (pass threshold) so
    the two always measure the same graph family.
    """
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_communities, nodes)
    rows, cols = [], []
    for c in range(n_communities):
        members = np.where(labels == c)[0]
        deg = intra_edges_per_node * len(members)
        rows.append(rng.choice(members, deg))
        cols.append(rng.choice(members, deg))
    rows.append(rng.randint(0, nodes, inter_edges_per_node * nodes))
    cols.append(rng.randint(0, nodes, inter_edges_per_node * nodes))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    A = sp.csc_matrix(
        (np.ones(len(r), np.float32), (r, c)), shape=(nodes, nodes)
    )
    A = ((A + A.T) > 0).astype(np.float32)
    return A.tocsc(), labels
