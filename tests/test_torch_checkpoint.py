"""The port's segmented checkpoint driver (common/checkpoint.py:
run_nmf_with_checkpointing) against the JAX package's, in f64 on the CPU.

Both drivers run the same segments (the same max_iter and min_iter a
segment, the same host round trip of W and H between them), so they stop
at the same total with the same success, and W and H agree to 1e-9
relative to their largest entry (f64 sums in another order).  The two
packages write the same checkpoint format, so each reads the other's
file, and a resume at max_iter returns without solving.
"""

import numpy as np
import pytest

import smallk_torch.common.checkpoint as tck
from smallk_tpu.common import checkpoint as jck
from smallk_tpu.common.options import NmfAlgorithm as JAlg
from smallk_tpu.common.options import NmfOptions as JOpts
from smallk_tpu.common.rng import Random, random_matrix
from smallk_torch.common.options import NmfAlgorithm, NmfOptions
from smallk_torch.solvers import solve as tsolve

TOL = 1e-9


def _problem(m=40, n=36, k=4):
    rng = Random(7)
    A = np.abs(random_matrix(m, n, rng))
    return A, random_matrix(m, k, rng), random_matrix(k, n, rng)


def _opts(cls, alg, A, k, **kw):
    m, n = A.shape
    base = dict(tol=1e-9, algorithm=alg, height=m, width=n, k=k,
                min_iter=1, max_iter=60, verbose=False, dtype="float64")
    base.update(kw)
    return cls(**base)


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("alg,every,kw", [
    ("MU", 20, {}),
    ("BPP", 7, {}),
    ("HALS", 25, {"tol": 1e-4, "max_iter": 200}),
    ("RANK2", 10, {"tol": 1e-5, "max_iter": 300}),
])
def test_segmented_run_matches_reference(alg, every, kw, tmp_path):
    k = 2 if alg == "RANK2" else 4
    A, W0, H0 = _problem(k=k)
    ref = jck.run_nmf_with_checkpointing(
        A, W0, H0, _opts(JOpts, getattr(JAlg, alg), A, k, **kw),
        str(tmp_path / "ref.npz"), checkpoint_every=every)
    got = tck.run_nmf_with_checkpointing(
        A, W0, H0, _opts(NmfOptions, getattr(NmfAlgorithm, alg), A, k, **kw),
        str(tmp_path / "port.npz"), checkpoint_every=every, device="cpu")
    assert got[2:] == (int(ref[2]), bool(ref[3]))
    assert _rel(got[0], np.asarray(ref[0])) <= TOL
    assert _rel(got[1], np.asarray(ref[1])) <= TOL


def test_each_package_reads_the_others_file(tmp_path):
    A, W0, H0 = _problem()
    jopts, topts = _opts(JOpts, JAlg.MU, A, 4), _opts(NmfOptions,
                                                      NmfAlgorithm.MU, A, 4)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.run_nmf_with_checkpointing(A, W0, H0, jopts, jpath,
                                   checkpoint_every=20)
    tck.run_nmf_with_checkpointing(A, W0, H0, topts, tpath,
                                   checkpoint_every=20, device="cpu")
    for path in (jpath, tpath):
        mine = tck.load_nmf_checkpoint(path, topts)
        theirs = jck.load_nmf_checkpoint(path, jopts)
        assert mine["iteration"] == theirs["iteration"] == 60
        np.testing.assert_array_equal(mine["W"], theirs["W"])
        np.testing.assert_array_equal(mine["H"], theirs["H"])
    # a resume from the reference's finished file, in the port
    W, _, total, ok = tck.run_nmf_with_checkpointing(
        A, W0, H0, topts, jpath, checkpoint_every=20, device="cpu")
    assert (total, ok) == (60, True)
    np.testing.assert_array_equal(W, jck.load_nmf_checkpoint(jpath)["W"])


def test_resume_at_max_iter_does_not_solve(tmp_path, monkeypatch):
    A, W0, H0 = _problem()
    opts = _opts(NmfOptions, NmfAlgorithm.MU, A, 4)
    path = str(tmp_path / "c.npz")
    W1, H1, it1, ok1 = tck.run_nmf_with_checkpointing(
        A, W0, H0, opts, path, checkpoint_every=20, device="cpu")
    assert it1 == 60 and ok1

    def boom(*a, **kw):
        raise AssertionError("a finished checkpoint solved again")

    monkeypatch.setattr(tsolve, "nmf_solve", boom)
    W2, H2, it2, ok2 = tck.run_nmf_with_checkpointing(
        A, W0, H0, opts, path, checkpoint_every=20, device="cpu")
    assert it2 == 60
    np.testing.assert_array_equal(W1, W2)
    np.testing.assert_array_equal(H1, H2)


def test_interrupted_run_resumes_to_the_same_result(tmp_path, monkeypatch):
    """A run cut after its second segment and resumed gives the bits of
    the run that was never cut."""
    A, W0, H0 = _problem()
    opts = _opts(NmfOptions, NmfAlgorithm.MU, A, 4)
    whole = tck.run_nmf_with_checkpointing(
        A, W0, H0, opts, str(tmp_path / "a.npz"), checkpoint_every=20,
        device="cpu")
    path = str(tmp_path / "b.npz")
    real, calls = tsolve.nmf_solve, []

    def cut(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt("preempted")
        return real(*a, **kw)

    monkeypatch.setattr(tsolve, "nmf_solve", cut)
    with pytest.raises(KeyboardInterrupt):
        tck.run_nmf_with_checkpointing(A, W0, H0, opts, path,
                                       checkpoint_every=20, device="cpu")
    assert tck.load_nmf_checkpoint(path)["iteration"] == 40
    monkeypatch.setattr(tsolve, "nmf_solve", real)
    again = tck.run_nmf_with_checkpointing(A, W0, H0, opts, path,
                                           checkpoint_every=20, device="cpu")
    assert again[2:] == whole[2:]
    np.testing.assert_array_equal(again[0], whole[0])
    np.testing.assert_array_equal(again[1], whole[1])
