"""The masked CG loop's device form (smallk_torch/solvers/nnls.
_cg_solve_block): on the CPU through the stand-in WHILE node of
tests/test_torch_bpp_graph.py (the loop's body under a dispatch mode that
refuses every host read but the node's of its handle between steps)
against the JAX package's _cg_solve_block (smallk_tpu/solvers/
nnls.py:120-222), in f64: the same x and the same number of steps, since
the node tests after every step as the JAX while_loop does; and through
the test-only select form (nnls.SELECT_ROUNDS), bit for bit the node's.

The step count is held equal to the JAX body's evaluated op by op
(jax.disable_jit).  Compiled, XLA fuses the body's elementwise ops and
rounds them otherwise, and once a column has converged its residual is
rounding noise at the 64 eps stop threshold: at k = 3, warm, the compiled
loop stops one step earlier (3 against 4) than the op-by-op one and the
port, whose x agree with both.  So the compiled count is held within one
step.
On the card (tests marked `cuda`): a host read in a CG body makes a BPP
step's capture raise.

Tolerance: x to 1e-10 absolute (f64, the same arithmetic in two
frameworks; the systems' solutions are O(1)).  The host form, with its
8-step checks, keeps its own tests (tests/test_torch_cg.py).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bpp_graph import HostReads, _f64_problem, stand_in

import smallk_tpu.solvers.nnls as jnnls
from smallk_torch.solvers import graph, solve
from smallk_torch.solvers import nnls as tnnls

torch.set_num_threads(1)

ATOL = 1e-10


def _system(k, n, seed, start):
    """An SPD Gram with a dead topic past k = 3, a right-hand side, a
    passive set and, warm, a start with a non-finite entry (its column
    starts cold)."""
    rng = np.random.RandomState(seed)
    B = rng.rand(3 * k, k)
    if k > 3:
        B[:, 1] = 0.0
    LHS = B.T @ B
    RHS = B.T @ rng.rand(3 * k, n)
    passive = rng.rand(k, n) < 0.6
    x0 = None
    if start == "warm":
        x0 = rng.rand(k, n)
        x0[0, 2] = np.inf
    return LHS, RHS, passive, x0


def _jax(LHS, RHS, passive, x0, monkeypatch, jit=True):
    """The JAX package's x and its while_loop's step count `it`, compiled
    or (jit false) op by op."""
    its = []
    while_loop = jax.lax.while_loop

    def recording(cond, body, init):
        out = while_loop(cond, body, init)
        its.append(int(out[-1]))
        return out

    monkeypatch.setattr(jax.lax, "while_loop", recording)
    with jax.disable_jit(not jit):
        x = jnnls._cg_solve_block(jnp.asarray(LHS), jnp.asarray(RHS),
                                  jnp.asarray(passive),
                                  None if x0 is None else jnp.asarray(x0))
    monkeypatch.setattr(jax.lax, "while_loop", while_loop)
    assert len(its) == 1
    return np.asarray(x), its[0]


def _port(LHS, RHS, passive, x0):
    return tnnls._cg_solve_block(
        torch.from_numpy(LHS), torch.from_numpy(RHS),
        torch.from_numpy(passive), None if x0 is None else torch.from_numpy(x0))


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("k", [3, 8, 20])
def test_device_form_cg_matches_jax_step_for_step(k, start, monkeypatch):
    """On the stand-in WHILE node the CG loop reads nothing from the host,
    returns the JAX package's x and runs its steps, as many as its `it`
    op by op (within one of the compiled loop's): the node's trips and
    nnls.cg_steps alike.  The select form gives the node's bits."""
    LHS, RHS, passive, x0 = _system(k, 3 * k + 5, k, start)
    want, it_compiled = _jax(LHS, RHS, passive, x0, monkeypatch)
    want_ops, it = _jax(LHS, RHS, passive, x0, monkeypatch, jit=False)
    assert it > 0 and abs(it - it_compiled) <= 1
    monkeypatch.setattr(tnnls, "cg_steps", 0)
    monkeypatch.setattr(tnnls, "cg_solves", 0)
    mode = HostReads()
    node = stand_in(monkeypatch, mode)
    with mode:
        got = _port(LHS, RHS, passive, x0)
    assert node.trips == [it] and tnnls.cg_steps == it
    assert tnnls.cg_solves == 1
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_ops, rtol=0, atol=ATOL)
    monkeypatch.setattr(graph, "capturing", lambda: False)
    monkeypatch.setattr(tnnls, "SELECT_ROUNDS", True)
    assert torch.equal(_port(LHS, RHS, passive, x0), got)


def test_device_form_cg_stops_at_the_cap_as_jax(monkeypatch):
    """With the step cap strangled below what the columns need, the node
    stops at the cap, as JAX's does, and both poison the same columns."""
    LHS, RHS, passive, _ = _system(20, 40, 4, "cold")
    passive[:, :3] = True
    for mod in (tnnls, jnnls):
        monkeypatch.setattr(mod, "_CG_EXTRA_STEPS", -15)
    want, it = _jax(LHS, RHS, passive, None, monkeypatch)
    assert it == 5
    mode = HostReads()
    node = stand_in(monkeypatch, mode)
    with mode:
        got = _port(LHS, RHS, passive, None).numpy()
    assert node.trips == [it]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any()
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_a_host_read_in_a_cg_body_makes_capture_raise(monkeypatch):
    """A CG step that reads the host cannot be captured: a BPP solve at
    k = 160 raises, it does not run the loop eagerly instead; the card
    and its random generator work after it, and the eager loop runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from smallk_torch.common.device import setup

    dev = setup("cuda")
    a_op, W0, H0, opts = _f64_problem(dev, 160)
    real = tnnls._Cg

    class Reading(real):
        def __new__(cls, *fields):
            if sys._getframe(1).f_code.co_name == "step":
                bool(fields[4].any())   # a host read in the CG body
            return super().__new__(cls, *fields)

    monkeypatch.setattr(tnnls, "_Cg", Reading)
    monkeypatch.setattr(graph, "CAPTURE", True)
    with pytest.raises(RuntimeError):
        solve.nmf_solve(a_op, W0, H0, opts)
    torch.cuda.synchronize()
    assert torch.rand(4, device=dev).shape == (4,)
    monkeypatch.setattr(graph, "CAPTURE", False)
    assert solve.nmf_solve(a_op, W0, H0, opts).iterations == opts.max_iter
