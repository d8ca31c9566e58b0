"""Community detection on a graph adjacency matrix, end to end.

The workflow BASELINE's north star describes (dblp15-style community
recovery): load or generate a graph, symmetric degree normalization,
rank-2 HierNMF2 to k leaf communities under the graph presets, score
against ground truth when available.  Extension beyond the reference
(which treats graphs as generic sparse matrices with the text
defaults); the presets and their measurements live in
smallk_torch/engines/graph.py.

Usage:
    python examples/torch_drivers/community_graph.py \
        [--graphfile G.mtx] [--communities 20] [--seed 7] [--outdir .] \
        [--device cuda]

Without --graphfile, a 3000-node / 20-community planted-partition graph
is generated and the recovered communities are scored (NMI / F1).

The PyTorch port's copy of examples/drivers/community_graph.py: the same
flow through smallk_torch's engines, on --device (default cuda).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--graphfile", default="",
                   help="MatrixMarket adjacency (symmetric); generated "
                        "planted-partition graph when omitted")
    p.add_argument("--communities", type=int, default=20)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--outdir", default=".")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    from smallk_torch.common.rng import Random
    from smallk_torch.engines.graph import (
        graph_clust_options, normalized_adjacency,
    )
    from smallk_torch.engines.hierclust import clust_hier

    labels_true = None
    if args.graphfile:
        from smallk_torch.io.matrix_market import load_matrix_market

        G = load_matrix_market(args.graphfile)
        print(f"loaded {args.graphfile}: {G.shape}, nnz={G.nnz}")
    else:
        from smallk_torch.engines.corpus import planted_partition_graph

        G, labels_true = planted_partition_graph(
            3000, args.communities, seed=args.seed
        )
        print(f"generated planted-partition graph: {G.shape}, "
              f"nnz={G.nnz}, {args.communities} communities")

    Gn = normalized_adjacency(G)  # D^-1/2 A D^-1/2
    opts = graph_clust_options(args.communities)
    tree, stats = clust_hier(Gn, opts, Random(args.seed), device=args.device)

    assign = tree.assignments
    n_comm = len(set(int(c) for c in assign if c >= 0))
    print(f"{stats.nmf_count} factorizations, {stats.iter_count} "
          f"rank-2 iterations, {n_comm} communities")

    out = os.path.join(args.outdir,
                       f"communities_{args.communities}.csv")
    tree.write_assignments(out)
    print(f"wrote {out}")

    if labels_true is not None:
        from smallk_torch.engines.scoring import score_clustering

        s = score_clustering(assign, labels_true)
        print(f"vs ground truth: NMI={s['nmi']:.3f} "
              f"pairwise-F1={s['pairwise_f1']:.3f} "
              f"best-match-F1={s['best_match_f1']:.3f}")


if __name__ == "__main__":
    main()
