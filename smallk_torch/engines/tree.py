"""Binary cluster tree for hierarchical NMF — port of
smallk_tpu/engines/tree.py.

Reference: hierclust/include/tree.hpp (Tree / TreeNode).  Flat-array tree;
the root is not stored; children of the root occupy indices 0 and 1; each
split appends two nodes.  Node id == index in the node array.

A split's (m, 2) factor stays where the engine computed it: a numpy array
(the initdir path) or a torch tensor on the device.  For a tensor, each
child's topic vector is a `DeviceColumn`, a lazy view that is sliced only
when a consumer needs the vector; the batched consumers (top terms, the
flat-refinement W) stack the columns of all nodes in one device op.  The
reference's chain-engine slabs (SlabHolder, SlabPair) serve only the
multi-split chain and are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

NONE = -1
MAX_PRIORITY = np.finfo(np.float64).max


class DeviceColumn:
    """Lazy view of column `col` of a device-resident (m, 2) factor."""

    __slots__ = ("buf", "col")

    def __init__(self, buf: torch.Tensor, col: int):
        self.buf = buf
        self.col = col

    def materialize(self) -> torch.Tensor:
        return self.buf[:, self.col]


def _stack_topic_columns(nodes) -> torch.Tensor:
    """(m, len(nodes)) device stack of the nodes' DeviceColumns."""
    return torch.stack([node.topic_vector.materialize() for node in nodes],
                       dim=1)


def _rank_topic_columns(nodes, max_terms: int) -> np.ndarray:
    """(len(nodes), max_terms) int32 top-term indices of the nodes' device
    topic vectors: one stable descending argsort (ties by lower index, as
    assignments.top_terms) and one copy to the host."""
    stacked = _stack_topic_columns(nodes).T + 0.0  # -0.0 ties with +0.0
    order = torch.argsort(stacked, dim=1, descending=True, stable=True)
    return order[:, :max_terms].cpu().numpy().astype(np.int32)


@dataclasses.dataclass
class TreeNode:
    """Reference: TreeNode (tree.hpp:32-53)."""

    priority: float = 0.0
    # Pop-ordering key (== priority under the reference's "ndcg" policy;
    # priority * |docs| under "size_ndcg" — see ClustOptions.priority_method).
    # Gates that compare priorities against TrialSplit's min_priority always
    # use the raw `priority`; only the argmax pop uses this.
    pop_priority: float = 0.0
    parent_index: int = NONE
    left_child_index: int = NONE
    right_child_index: int = NONE
    is_valid: bool = False
    is_left_child: bool = False
    topic_vector: Optional[object] = None  # (m,) ndarray or DeviceColumn
    term_indices: Optional[np.ndarray] = None  # top-ranked term indices
    docs: Optional[np.ndarray] = None  # document indices at this node


class Tree:
    """Flat-array binary tree (reference Tree, tree.hpp:57-158)."""

    def __init__(self):
        self.nodes: List[TreeNode] = []
        self.is_leaf: List[bool] = []
        self.active_nodes = 0
        self.index0 = NONE
        self.index1 = NONE
        self.total_docs = 0
        self.term_count = 0
        self.leaf_doc_count = 0
        self.outliers: np.ndarray = np.empty(0, dtype=np.int64)
        self.assignments: np.ndarray = np.empty(0, dtype=np.int64)

    def init(self, num_clusters: int, term_count: int,
             doc_count: int) -> None:
        """Allocate the flat node array: 2*(num_clusters-1) nodes, two
        per split (reference Tree::Init, tree.hpp:92-109)."""
        node_count = 2 * (num_clusters - 1)
        self.total_docs = doc_count
        self.term_count = term_count
        self.nodes = [TreeNode() for _ in range(node_count)]
        self.is_leaf = [False] * node_count
        self.active_nodes = 0

    # --- split operations -------------------------------------------------

    def split_root(self, W, H=None, labels=None) -> None:
        """Partition all docs between the root's two children by
        H(0,c) > H(1,c) (reference SplitRoot, tree.hpp:223-263).

        `labels`: optional precomputed boolean "goes left" mask, as the
        engine computes it next to the factors."""
        self.index0, self.index1 = 0, 1
        for idx, is_left in ((0, True), (1, False)):
            node = self.nodes[idx]
            node.parent_index = NONE
            node.left_child_index = NONE
            node.right_child_index = NONE
            node.is_valid = True
            node.is_left_child = is_left
            self.is_leaf[idx] = True
        self.active_nodes += 2

        left = self._left_mask(H, labels)
        all_docs = np.arange(len(left), dtype=np.int64)
        self.nodes[0].docs = all_docs[left]
        self.nodes[1].docs = all_docs[~left]
        self._update_topic_vectors(W)

    @staticmethod
    def _left_mask(H, labels):
        if labels is not None:
            return np.asarray(labels, dtype=bool)
        H = np.asarray(H)
        return H[0, :] > H[1, :]

    def split(self, node_index: int, W, H=None, labels=None) -> None:
        """Split an existing leaf; H has one column per doc in the node's
        subset (reference Split, tree.hpp:267-317).  `labels` as in
        split_root."""
        self.index0 = self.active_nodes
        self.index1 = self.active_nodes + 1
        self.active_nodes += 2

        parent = self.nodes[node_index]
        parent.left_child_index = self.index0
        parent.right_child_index = self.index1
        self.is_leaf[node_index] = False

        for idx, is_left in ((self.index0, True), (self.index1, False)):
            node = self.nodes[idx]
            node.parent_index = node_index
            node.left_child_index = NONE
            node.right_child_index = NONE
            node.is_valid = True
            node.is_left_child = is_left
            self.is_leaf[idx] = True

        source_docs = parent.docs
        left = self._left_mask(H, labels)
        self.nodes[self.index0].docs = source_docs[left]
        self.nodes[self.index1].docs = source_docs[~left]
        self._update_topic_vectors(W)

    def _update_topic_vectors(self, W) -> None:
        if isinstance(W, torch.Tensor):
            # keep the factor on the device: lazy column views, sliced
            # only by a consumer that needs the vector
            self.nodes[self.index0].topic_vector = DeviceColumn(W, 0)
            self.nodes[self.index1].topic_vector = DeviceColumn(W, 1)
        else:
            W = np.asarray(W)
            self.nodes[self.index0].topic_vector = np.array(W[:, 0])
            self.nodes[self.index1].topic_vector = np.array(W[:, 1])

    # --- queries ----------------------------------------------------------

    def min_max_leaf_priorities(self):
        """Returns (min_pos_priority, max_pop_priority, max_index).
        Min considers only positive RAW priorities (tree.hpp:193-219) —
        it feeds TrialSplit's outlier gate, which compares NDCG values;
        the argmax uses pop_priority (== priority unless a size-aware
        pop policy is active)."""
        min_p = np.finfo(np.float64).max
        max_p = -np.finfo(np.float64).max
        max_idx = NONE
        for q, leaf in enumerate(self.is_leaf):
            if not leaf:
                continue
            p = self.nodes[q].priority
            if 0 < p < min_p:
                min_p = p
            pp = self.nodes[q].pop_priority
            if pp > max_p:
                max_p = pp
                max_idx = q
        return min_p, max_p, max_idx

    def set_node_priority(self, node_index: int, priority: float,
                          pop_priority: float | None = None) -> None:
        self.nodes[node_index].priority = float(priority)
        self.nodes[node_index].pop_priority = float(
            priority if pop_priority is None else pop_priority
        )

    def left_child_docs(self):
        return self.nodes[self.index0].docs

    def right_child_docs(self):
        return self.nodes[self.index1].docs

    def left_child_topic_vector(self):
        return self.nodes[self.index0].topic_vector

    def right_child_topic_vector(self):
        return self.nodes[self.index1].topic_vector

    # --- results ----------------------------------------------------------

    def compute_top_terms(self, max_terms: int) -> None:
        """Top-term indices of every valid node's topic vector: host
        vectors by assignments.top_terms, device vectors in one batched
        argsort and one copy to the host."""
        from .assignments import top_terms

        dev = []
        for node in self.nodes:
            tv = node.topic_vector
            if not node.is_valid or tv is None:
                continue
            if isinstance(tv, DeviceColumn):
                dev.append(node)
            else:
                node.term_indices = top_terms(tv, max_terms)
        if dev:
            order = _rank_topic_columns(dev, max_terms)
            for q, node in enumerate(dev):
                node.term_indices = order[q]

    def compute_assignments(self) -> None:
        """Docs in leaf nodes get the leaf index; unassigned docs are
        outliers labeled -1 (reference ComputeAssignments, tree.hpp:375)."""
        self.assignments = np.full(self.total_docs, NONE, dtype=np.int64)
        self.leaf_doc_count = 0
        for q, leaf in enumerate(self.is_leaf):
            if not leaf:
                continue
            docs = self.nodes[q].docs
            self.leaf_doc_count += len(docs)
            self.assignments[docs] = q
        self.outliers = np.where(self.assignments == NONE)[0]
        assert self.leaf_doc_count + len(self.outliers) == self.total_docs

    def flatclust_init_w(self, m: int, k: int):
        """Leaf topic vectors -> (m, k) W initializer for flat refinement
        (reference FlatclustInitW, tree.hpp:414-460).  A device tensor
        when the vectors live on the device, else a host array."""
        leaves = [q for q, leaf in enumerate(self.is_leaf) if leaf]
        if len(leaves) != k:
            raise ValueError(
                f"flatclust needs {k} leaves, tree has {len(leaves)}"
            )
        nodes = [self.nodes[q] for q in leaves]
        if all(isinstance(n.topic_vector, DeviceColumn) for n in nodes):
            return _stack_topic_columns(nodes)
        W = np.zeros((m, k))
        for c, node in enumerate(nodes):
            W[:, c] = _host(node.topic_vector)
        return W

    # --- serialization (checkpoint/resume support) ------------------------

    def to_arrays(self) -> dict:
        """Serialize the tree into flat arrays (for npz checkpoints)."""
        out = {
            "node_count": np.int64(len(self.nodes)),
            "total_docs": np.int64(self.total_docs),
            "term_count": np.int64(self.term_count),
            "active_nodes": np.int64(self.active_nodes),
            "index0": np.int64(self.index0),
            "index1": np.int64(self.index1),
            "is_leaf": np.asarray(self.is_leaf, dtype=bool),
            "priority": np.array([n.priority for n in self.nodes]),
            "pop_priority": np.array(
                [n.pop_priority for n in self.nodes]
            ),
            "parent": np.array([n.parent_index for n in self.nodes],
                               dtype=np.int64),
            "left": np.array([n.left_child_index for n in self.nodes],
                             dtype=np.int64),
            "right": np.array([n.right_child_index for n in self.nodes],
                              dtype=np.int64),
            "is_valid": np.array([n.is_valid for n in self.nodes],
                                 dtype=bool),
            "is_left_child": np.array(
                [n.is_left_child for n in self.nodes], dtype=bool
            ),
        }
        docs = [
            n.docs if n.docs is not None else np.empty(0, np.int64)
            for n in self.nodes
        ]
        out["docs_flat"] = (
            np.concatenate(docs) if docs else np.empty(0, np.int64)
        )
        out["docs_offsets"] = np.cumsum(
            [0] + [len(d) for d in docs]
        ).astype(np.int64)
        out["has_docs"] = np.array(
            [n.docs is not None for n in self.nodes], dtype=bool
        )
        tv = [
            _host(n.topic_vector) if n.topic_vector is not None
            else np.zeros(self.term_count)
            for n in self.nodes
        ]
        out["topic_vectors"] = (
            np.stack(tv, axis=1) if tv else np.zeros((0, 0))
        )
        out["has_tv"] = np.array(
            [n.topic_vector is not None for n in self.nodes], dtype=bool
        )
        return out

    @classmethod
    def from_arrays(cls, arrs) -> "Tree":
        """Rebuild a tree from to_arrays output (topic vectors come back
        as host arrays)."""
        tree = cls()
        nc = int(arrs["node_count"])
        tree.total_docs = int(arrs["total_docs"])
        tree.term_count = int(arrs["term_count"])
        tree.active_nodes = int(arrs["active_nodes"])
        tree.index0 = int(arrs["index0"])
        tree.index1 = int(arrs["index1"])
        tree.is_leaf = [bool(x) for x in arrs["is_leaf"]]
        tree.nodes = []
        offs = arrs["docs_offsets"]
        for q in range(nc):
            node = TreeNode(
                priority=float(arrs["priority"][q]),
                pop_priority=float(arrs["pop_priority"][q]),
                parent_index=int(arrs["parent"][q]),
                left_child_index=int(arrs["left"][q]),
                right_child_index=int(arrs["right"][q]),
                is_valid=bool(arrs["is_valid"][q]),
                is_left_child=bool(arrs["is_left_child"][q]),
            )
            if bool(arrs["has_docs"][q]):
                node.docs = np.array(
                    arrs["docs_flat"][offs[q]:offs[q + 1]], dtype=np.int64
                )
            if bool(arrs["has_tv"][q]):
                node.topic_vector = np.array(arrs["topic_vectors"][:, q])
            tree.nodes.append(node)
        return tree

    def write_assignments(self, filepath: str) -> None:
        """Two-section CSV: labels (-1 for outliers), blank line, outlier
        indices (reference WriteAssignments, tree.hpp:464-506)."""
        with open(filepath, "w") as f:
            f.write(",".join(str(int(a)) for a in self.assignments))
            f.write("\n\n")
            if len(self.outliers) > 0:
                f.write(",".join(str(int(q)) for q in self.outliers))
                f.write("\n")

    def write_tree(self, writer, filepath: str, dictionary) -> None:
        """Emit all nodes through a result writer (XML/JSON)."""
        with open(filepath, "w") as f:
            writer.write_header(f, self.leaf_doc_count)
            for q, node in enumerate(self.nodes):
                writer.write_node(
                    f,
                    node_id=q,
                    parent_id=node.parent_index,
                    is_left_child=node.is_left_child,
                    left_child_id=node.left_child_index,
                    right_child_id=node.right_child_index,
                    doc_count=0 if node.docs is None else len(node.docs),
                    term_indices=(
                        [] if node.term_indices is None
                        else list(node.term_indices)
                    ),
                    dictionary=dictionary,
                )
            writer.write_footer(f)


def _host(tv) -> np.ndarray:
    """A topic vector as a host array."""
    if isinstance(tv, DeviceColumn):
        return tv.materialize().cpu().numpy()
    return np.asarray(tv)
