"""Factor matrices as embedding tables — port of
smallk_tpu/engines/embeddings.py.

The reference stops at writing w.csv/h.csv; this module adds the
serving-side operations on the factors of A ~= W H:

  - the tables on the card (W as the term table, H' as the doc table)
  - cosine / dot-product top-k retrieval (docs for a topic, terms for a
    topic, nearest docs for a doc, docs for a term-weight query)
  - npz export with the reference's keys (W, Ht), so each package loads
    the other's file

Products are `torch.matmul` with f32 scores (bf16 tables upcast first,
f64 tables' products rounded to f32), the counterpart of the reference's
`preferred_element_type=jnp.float32`; selection is a stable sort, so
tied scores go to the lower index, as `lax.top_k` orders them.  There is
no hand-written kernel here: the reference's retrieval is XLA code, not a
Pallas kernel.

With `mesh` (parallel/mesh.Mesh) a table is row-sharded over one of its
axes (`shard_axis`, default the first): each rank holds its block of rows
on the mesh's device.  A top-k is the block's top-k, then the candidates
of every block of the axis (gathered) merged: the unsharded indices and
values, ties to the lower index.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.device import setup
from ..parallel.mesh import block_bounds, check_mesh


def normalize_rows(X, eps=1e-12):
    n = torch.linalg.norm(X, dim=1, keepdim=True)
    return X / torch.clamp(n, min=eps)


def _f32_scores(a, b):
    """a @ b with f32 scores: half-width inputs are upcast before the
    product, f64 products are rounded after it."""
    if a.dtype in (torch.bfloat16, torch.float16):
        a, b = a.float(), b.float()
    return torch.matmul(a, b).to(torch.float32)


def _host(t):
    return t.cpu().numpy()


def _topk(scores, k):
    """(values, indices) of the top k of each row, ties to the lower
    index."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


class EmbeddingTable:
    """A (count x dim) embedding table on the device with top-k
    retrieval; with `mesh`, this rank's rows [row0, row0 + rows) of it on
    the mesh's device (`table`)."""

    def __init__(self, table, mesh=None, shard_axis: str | None = None,
                 device="cuda"):
        self.mesh = check_mesh(mesh, "EmbeddingTable")
        table = torch.as_tensor(table)
        self._shape = tuple(table.shape)
        self.row0 = 0
        if mesh is None:
            dev = setup(device)
        else:
            dev = mesh.device
            axis = shard_axis or mesh.axis_names[0]
            if axis not in mesh.axis_names:
                raise ValueError(f"shard_axis {axis!r}: the mesh's axes are "
                                 f"{mesh.axis_names}")
            self.role = ("terms", "docs")[mesh.axis_names.index(axis)]
            self.row0, r1 = block_bounds(self._shape[0],
                                         mesh.axis_size(self.role),
                                         mesh.axis_index(self.role))
            table = table[self.row0:r1]
        self.table = table.to(dev).contiguous()
        self._normed = None

    @property
    def shape(self):
        return self._shape

    def row(self, i: int):
        """Row i of the whole table (from the rank that holds it)."""
        if self.mesh is None:
            return self.table[i]
        mine = self.row0 <= i < self.row0 + self.table.shape[0]
        r = (self.table[i - self.row0] if mine
             else torch.zeros_like(self.table[0]))
        # adding the other ranks' zeros leaves the row's bits
        return self.mesh.all_reduce(r, self.role, "sum")

    def full(self):
        """The whole table (gathered over the axis with a mesh)."""
        if self.mesh is None:
            return self.table
        return self.mesh.gather(self.table, self.role, 0, self._shape[0])

    def _select(self, scores, k):
        """(indices, values) of the top k of each row of `scores`, on the
        host; with a mesh, over every rank's block of rows."""
        if k > self._shape[0]:
            raise ValueError(f"top-{k} of a table of {self._shape[0]} rows")
        if self.mesh is None:
            vals, idx = _topk(scores, k)
            return _host(idx), _host(vals)
        vals, idx = _topk(scores, min(k, scores.shape[1]))
        idx = idx + self.row0
        if idx.shape[1] < k:
            # a block of fewer than k rows: candidates that lose every tie
            pad = (scores.shape[0], k - idx.shape[1])
            vals = torch.cat([vals, vals.new_full(pad, -torch.inf)], dim=1)
            idx = torch.cat([idx, idx.new_full(pad, self._shape[0])], dim=1)
        parts = self.mesh.axis_size(self.role)
        vals = self.mesh.gather(vals, self.role, 1, k * parts)
        idx = self.mesh.gather(idx, self.role, 1, k * parts)
        # the candidates ordered by row index, then a stable sort by value:
        # ties go to the lower index
        order = torch.argsort(idx, dim=1)
        idx, vals = idx.gather(1, order), vals.gather(1, order)
        top = torch.argsort(vals, dim=1, descending=True, stable=True)[:, :k]
        return _host(idx.gather(1, top)), _host(vals.gather(1, top))

    def _norm_table(self):
        if self._normed is None:
            self._normed = normalize_rows(self.table)
        return self._normed

    def _queries(self, queries):
        q = torch.as_tensor(queries, dtype=self.table.dtype,
                            device=self.table.device)
        return torch.atleast_2d(q)

    def topk_dot(self, queries, k=10):
        """Top-k rows by dot product.  queries: (q, dim) or (dim,)."""
        return self._select(_f32_scores(self._queries(queries), self.table.T),
                          k)

    def topk_cosine(self, queries, k=10):
        q = normalize_rows(self._queries(queries))
        return self._select(_f32_scores(q, self._norm_table().T), k)


class NmfEmbeddings:
    """Retrieval views over an NMF factorization A ~= W H.

    W (m x k): term/topic table — row i embeds term i in topic space.
    H (k x n): doc codes — column j embeds document j.
    With `mesh`, both tables are row-sharded over its first axis.
    """

    def __init__(self, W, H, mesh=None, device="cuda"):
        check_mesh(mesh, "NmfEmbeddings")
        self.terms = EmbeddingTable(W, mesh, device=device)
        self.docs = EmbeddingTable(torch.as_tensor(H).T, mesh, device=device)

    def top_docs_for_topic(self, topic: int, k=10):
        """Documents with the largest loading on a topic."""
        kdim = self.docs.shape[1]
        q = np.zeros(kdim, dtype=np.float32)
        q[topic] = 1.0
        idx, vals = self.docs.topk_dot(q, k)
        return idx[0], vals[0]

    def top_terms_for_topic(self, topic: int, k=10):
        kdim = self.terms.shape[1]
        q = np.zeros(kdim, dtype=np.float32)
        q[topic] = 1.0
        idx, vals = self.terms.topk_dot(q, k)
        return idx[0], vals[0]

    def similar_docs(self, doc: int, k=10):
        """Nearest documents in code space (cosine), excluding self."""
        q = self.docs.row(doc)
        idx, vals = self.docs.topk_cosine(q, k + 1)
        keep = idx[0] != doc
        return idx[0][keep][:k], vals[0][keep][:k]

    def embed_query_terms(self, term_weights):
        """Project a sparse term-weight query into topic space: q = wᵀW."""
        t = self.terms
        w = torch.as_tensor(term_weights, dtype=t.table.dtype,
                            device=t.table.device)
        if t.mesh is None:
            return _host(_f32_scores(w, t.table))
        w = w[..., t.row0:t.row0 + t.table.shape[0]]
        return _host(t.mesh.all_reduce(_f32_scores(w, t.table), t.role,
                                       "sum"))

    def search(self, term_weights, k=10):
        """Retrieve documents for a term-space query."""
        q = self.embed_query_terms(term_weights)
        idx, vals = self.docs.topk_cosine(q, k)
        return idx[0], vals[0]

    def save(self, path: str) -> None:
        """npz with the reference's keys; with a mesh every rank takes
        part and the coordinator writes."""
        W, Ht = _host(self.terms.full()), _host(self.docs.full())
        mesh = self.terms.mesh
        if mesh is None or mesh.is_coordinator:
            np.savez_compressed(path, W=W, Ht=Ht)
        if mesh is not None:
            mesh.barrier()

    @classmethod
    def load(cls, path: str, mesh=None, device="cuda"):
        with np.load(path) as z:
            return cls(z["W"], z["Ht"].T, mesh=mesh, device=device)
