"""The port's embedding tables (engines/embeddings.py) against the JAX
package's: top-k indices and values on the same factors (f64 tables,
f32 scores in both), bf16 tables carried across by
interop.embeddings_from_reference, and each package's .npz loaded by the
other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallk_tpu.engines.embeddings import EmbeddingTable as JTable
from smallk_tpu.engines.embeddings import NmfEmbeddings as JEmb
from smallk_tpu.engines.embeddings import normalize_rows as jnormalize_rows
from smallk_torch.engines.embeddings import (
    EmbeddingTable,
    NmfEmbeddings,
    normalize_rows,
)
from smallk_torch.interop import embeddings_from_reference

torch.set_num_threads(1)

VAL_TOL = dict(rtol=1e-6, atol=1e-7)   # f32 scores, other summation orders


def _factors(m=50, k=4, n=30, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(m, k), rng.rand(k, n)


def _same_topk(got, want, scores=None):
    """Equal values, and equal indices except between tied scores: where
    `scores` (every row's exact score) is given, an index may differ from
    the reference's where the two rows score the same (torch.topk breaks
    ties in its own order, lax.top_k by the lower index)."""
    idx, vals = got
    jidx, jvals = np.asarray(want[0]), np.asarray(want[1])
    assert vals.dtype == np.float32
    np.testing.assert_allclose(vals, jvals, **VAL_TOL)
    if scores is None:
        np.testing.assert_array_equal(idx, jidx)
    else:
        assert len(set(idx.tolist())) == len(idx)
        np.testing.assert_array_equal(scores[idx], scores[jidx])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retrieval_matches_reference(seed):
    W, H = _factors(seed=seed)
    emb, jemb = NmfEmbeddings(W, H, device="cpu"), JEmb(W, H)
    assert emb.docs.shape == (30, 4) and emb.terms.shape == (50, 4)
    for topic in range(4):
        _same_topk(emb.top_docs_for_topic(topic, k=5),
                   jemb.top_docs_for_topic(topic, k=5))
        _same_topk(emb.top_terms_for_topic(topic, k=3),
                   jemb.top_terms_for_topic(topic, k=3))
    for doc in (0, 7, 29):
        idx, vals = emb.similar_docs(doc, k=5)
        assert doc not in idx and len(idx) == 5
        assert (np.diff(vals) <= 1e-6).all()  # descending scores
        _same_topk((idx, vals), jemb.similar_docs(doc, k=5))
    q = np.zeros(50)
    q[:5] = 1.0
    np.testing.assert_allclose(emb.embed_query_terms(q),
                               np.asarray(jemb.embed_query_terms(q)),
                               **VAL_TOL)
    _same_topk(emb.search(q, k=4), jemb.search(q, k=4))
    # the reference's own check: the top docs of a topic by numpy
    idx, _ = emb.top_docs_for_topic(2, k=5)
    np.testing.assert_array_equal(np.sort(idx), np.sort(
        np.argsort(-H[2, :])[:5]))


def test_tables_batched_queries():
    W, _ = _factors(seed=3)
    rng = np.random.RandomState(4)
    Q = rng.rand(6, 4)
    table, jtable = EmbeddingTable(W, device="cpu"), JTable(W)
    _same_topk(table.topk_dot(Q, k=7), jtable.topk_dot(Q, k=7))
    _same_topk(table.topk_cosine(Q, k=7), jtable.topk_cosine(Q, k=7))
    idx, vals = table.topk_cosine(Q, k=7)
    assert idx.shape == vals.shape == (6, 7)
    X = rng.rand(5, 3)
    X[2] = 0.0   # a zero row stays zero (eps floor)
    np.testing.assert_allclose(normalize_rows(torch.from_numpy(X)).numpy(),
                               np.asarray(jnormalize_rows(jnp.asarray(X))),
                               rtol=1e-12)


def test_bf16_tables_carried_across():
    """A reference table in bf16 crosses over bit for bit; scores in f32
    from the upcast table, as preferred_element_type=f32 gives them."""
    W, H = _factors(m=64, k=8, n=40, seed=5)
    jemb = JEmb(jnp.asarray(W, jnp.bfloat16), jnp.asarray(H, jnp.bfloat16))
    emb = embeddings_from_reference(jemb, device="cpu")
    assert emb.docs.table.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.terms.table.float().numpy(),
        np.asarray(jemb.terms.table.astype(jnp.float32)))
    # bf16 tables tie often; their exact scores (f64 sums of bf16
    # products) decide which indices may trade places
    Ht = emb.docs.table.double().numpy()
    for topic in (0, 5):
        _same_topk(emb.top_docs_for_topic(topic, k=6),
                   jemb.top_docs_for_topic(topic, k=6), Ht[:, topic])
    (idx,), (vals,) = emb.docs.topk_dot(np.ones(8), k=6)
    (jidx,), (jvals,) = jemb.docs.topk_dot(np.ones(8), k=6)
    _same_topk((idx, vals), (jidx, jvals), Ht.sum(axis=1))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_loads_in_either_package(writer, tmp_path):
    W, H = _factors(m=20, k=3, n=10, seed=1)
    path = str(tmp_path / "emb.npz")
    (NmfEmbeddings(W, H, device="cpu") if writer == "port"
     else JEmb(W, H)).save(path)
    with np.load(path) as z:
        assert sorted(z.files) == ["Ht", "W"]
    emb, jemb = NmfEmbeddings.load(path, device="cpu"), JEmb.load(path)
    np.testing.assert_array_equal(emb.docs.table.numpy(), H.T)
    np.testing.assert_array_equal(emb.terms.table.numpy(), W)
    np.testing.assert_array_equal(np.asarray(jemb.docs.table), H.T)
    _same_topk(emb.similar_docs(3, k=4), jemb.similar_docs(3, k=4))


def test_mesh_raises_and_default_device():
    W, H = _factors()
    # a mesh that is not the port's (a JAX mesh, say) is refused
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        NmfEmbeddings(W, H, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        EmbeddingTable(W, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            NmfEmbeddings(W, H)
