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
`preferred_element_type=jnp.float32`; selection is `torch.topk`.  There
is no hand-written kernel here: the reference's retrieval is XLA code,
not a Pallas kernel.  `mesh=` (the sharded tables) keeps its place and
raises (ROADMAP slice 15).
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.device import no_mesh, setup


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


class EmbeddingTable:
    """A (count x dim) embedding table on the device with top-k
    retrieval."""

    def __init__(self, table, mesh=None, shard_axis: str | None = None,
                 device="cuda"):
        no_mesh(mesh, "EmbeddingTable")
        dev = setup(device)
        self.table = torch.as_tensor(table).to(dev).contiguous()
        self._normed = None

    @property
    def shape(self):
        return tuple(self.table.shape)

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
        scores = _f32_scores(self._queries(queries), self.table.T)
        vals, idx = torch.topk(scores, k)
        return _host(idx), _host(vals)

    def topk_cosine(self, queries, k=10):
        q = normalize_rows(self._queries(queries))
        scores = _f32_scores(q, self._norm_table().T)
        vals, idx = torch.topk(scores, k)
        return _host(idx), _host(vals)


class NmfEmbeddings:
    """Retrieval views over an NMF factorization A ~= W H.

    W (m x k): term/topic table — row i embeds term i in topic space.
    H (k x n): doc codes — column j embeds document j.
    """

    def __init__(self, W, H, mesh=None, device="cuda"):
        no_mesh(mesh, "NmfEmbeddings")
        self.terms = EmbeddingTable(W, device=device)
        self.docs = EmbeddingTable(torch.as_tensor(H).T, device=device)

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
        q = self.docs.table[doc]
        idx, vals = self.docs.topk_cosine(q, k + 1)
        keep = idx[0] != doc
        return idx[0][keep][:k], vals[0][keep][:k]

    def embed_query_terms(self, term_weights):
        """Project a sparse term-weight query into topic space: q = wᵀW."""
        w = torch.as_tensor(term_weights, dtype=self.terms.table.dtype,
                            device=self.terms.table.device)
        return _host(_f32_scores(w, self.terms.table))

    def search(self, term_weights, k=10):
        """Retrieve documents for a term-space query."""
        q = self.embed_query_terms(term_weights)
        idx, vals = self.docs.topk_cosine(q, k)
        return idx[0], vals[0]

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            W=_host(self.terms.table),
            Ht=_host(self.docs.table),
        )

    @classmethod
    def load(cls, path: str, mesh=None, device="cuda"):
        with np.load(path) as z:
            return cls(z["W"], z["Ht"].T, mesh=mesh, device=device)
