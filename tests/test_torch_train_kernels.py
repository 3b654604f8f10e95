"""The port's training kernels (UPDATE and AGG, forward and backward) and
the hash dropout, against the reference on the same numpy inputs.

On the CPU each wrapper runs its plain PyTorch version.  The forwards are
held against the reference's Pallas kernels in interpret mode (as
``tests/test_kernels.py`` runs them) at the float32 tolerance of
``tests/test_kernels.py:23``, 1e-5; the dropout's zero pattern and the
hash bits are held exactly.  The gradients are held against ``jax.grad``
of the reference's jnp path — the function it trains with, since its
Pallas kernels cannot be differentiated — at rtol 1e-4 / atol 1e-5: the
products of the gradient sum float32 in another order than XLA's.  The
CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import ref as j_ref
from repro.models.gnn import common as j_common
from repro_torch.kernels import ref, sage_agg, update_fused
from repro_torch.models.gnn.common import hash_dropout, hash_uniform

TOL = dict(atol=1e-5, rtol=1e-5)
GTOL = dict(atol=1e-5, rtol=1e-4)
t = torch.as_tensor


def update_inputs(seed, N, C, K):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(N, C)).astype(np.float32),
            rng.normal(size=(N, C)).astype(np.float32),
            (rng.normal(size=(C, K)) * 0.1).astype(np.float32),
            (rng.normal(size=(C, K)) * 0.1).astype(np.float32),
            (rng.normal(size=K) * 0.1).astype(np.float32)]


@pytest.mark.parametrize("rows", [np.arange(300), np.array(
    [0, 1, 65535, 65536, 65537, 2 ** 20 + 3, 2 ** 31 - 1])])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31, 2 ** 32 - 1, 2 ** 32 - 5])
def test_hash_uniform_bit_exact(rows, seed):
    cols = np.array([0, 1, 2, 171, 255, 65536, 2 ** 24 + 1])
    got = hash_uniform(seed, t(rows), t(cols)).numpy()
    want = np.asarray(j_common.hash_uniform(
        jnp.uint32(seed), jnp.asarray(rows, jnp.int32),
        jnp.asarray(cols, jnp.int32)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hash_dropout_bit_exact(rate):
    x = np.random.default_rng(0).normal(size=(70, 33)).astype(np.float32)
    got = hash_dropout(t(x), rate, 9).numpy()
    want = np.asarray(j_common.hash_dropout(jnp.asarray(x), rate,
                                            jnp.uint32(9)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("N,C,K", [(64, 32, 64), (300, 96, 130),
                                   (257, 128, 256), (16, 100, 47),
                                   (257, 24, 47)])
@pytest.mark.parametrize("relu,dropout", [(True, 0.0), (True, 0.1),
                                          (True, 0.5), (False, 0.0),
                                          (False, 0.5)])
def test_update_forward_matches_pallas(N, C, K, relu, dropout):
    args = update_inputs(N + K, N, C, K)
    before = update_fused.update_fused_fwd.launches
    out = update_fused.update_fused_fwd(*map(t, args), relu=relu,
                                        dropout=dropout, seed=7).numpy()
    assert update_fused.update_fused_fwd.launches == before   # plain path
    pallas = np.asarray(ops.fused_update(
        *map(jnp.asarray, args), relu=relu, dropout=dropout,
        seed=jnp.uint32(7), interpret=True))
    np.testing.assert_allclose(out, pallas, **TOL)
    if dropout:
        dropped = np.asarray(j_common.hash_uniform(
            jnp.uint32(7), jnp.arange(N), jnp.arange(K))) < np.float32(dropout)
        assert (out[dropped] == 0).all() and (pallas[dropped] == 0).all()
        kept = ~dropped & (np.abs(pallas) > 1e-4)
        assert (out[kept] != 0).all()


def j_update_loss(args, g, relu, dropout, seed):
    out = j_ref.fused_update_ref(*args, relu=relu, dropout=dropout,
                                 seed=jnp.uint32(seed))
    return jnp.sum(out * g)


@pytest.mark.parametrize("N,C,K", [(64, 32, 64), (257, 24, 47),
                                   (16, 100, 130)])
@pytest.mark.parametrize("relu,dropout", [(True, 0.0), (True, 0.5),
                                          (False, 0.0), (False, 0.3)])
def test_update_gradient_matches_jax_grad(N, C, K, relu, dropout):
    args = update_inputs(N * 3 + K, N, C, K)
    g = np.random.default_rng(1).normal(size=(N, K)).astype(np.float32)
    want = jax.grad(j_update_loss)(tuple(map(jnp.asarray, args)),
                                   jnp.asarray(g), relu, dropout, 2 ** 32 - 2)
    tt = [t(a).requires_grad_() for a in args]
    out = update_fused.fused_update(*tt, relu=relu, dropout=dropout,
                                    seed=2 ** 32 - 2)
    got = torch.autograd.grad(out, tt, grad_outputs=t(g))
    for name, a, b in zip(("agg", "self", "wn", "ws", "b"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GTOL,
                                   err_msg=name)


def test_update_backward_skips_unneeded_input_grads():
    """Layer 0's inputs are the features: no dagg/dself is computed."""
    args = update_inputs(3, 20, 8, 6)
    agg, sh = t(args[0]), t(args[1])
    w = [t(a).requires_grad_() for a in args[2:]]
    out = update_fused.fused_update(agg, sh, *w, relu=True, dropout=0.2,
                                    seed=4)
    out.sum().backward()
    assert agg.grad is None and sh.grad is None
    assert all(p.grad is not None for p in w)


def agg_inputs(seed, N, M, f, D):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, D)).astype(np.float32)
    nbr = rng.integers(-1, N, (M, f)).astype(np.int32)
    nbr[0] = -1                                    # an all-masked row
    nbr[1] = np.where(nbr[1] >= 0, nbr[1], 0)      # ...and a full one
    valid = rng.random(N) > 0.15
    valid[0] = True
    return h, nbr, valid


@pytest.mark.parametrize("N,M,f,D", [(100, 30, 5, 32), (333, 64, 9, 64),
                                     (50, 50, 1, 128), (40, 12, 15, 7)])
def test_agg_forward_matches_pallas(N, M, f, D):
    h, nbr, valid = agg_inputs(M + D, N, M, f, D)
    mean, cnt = sage_agg.sage_agg_fwd(t(h), t(nbr), t(valid))
    pallas = np.asarray(ops.sage_agg(jnp.asarray(h), jnp.asarray(nbr),
                                     jnp.asarray(valid), interpret=True))
    np.testing.assert_allclose(mean.numpy(), pallas, **TOL)
    assert (mean.numpy()[0] == 0).all()
    idx = np.maximum(nbr, 0)
    np.testing.assert_array_equal(
        cnt.numpy(), ((nbr >= 0) & valid[idx]).sum(1).astype(np.float32))


def j_agg_loss(h, nbr, valid, g):
    feats, mask = j_common.gather_neighbors(h, nbr, valid)
    return jnp.sum(j_common.masked_mean(feats, mask) * g)


@pytest.mark.parametrize("N,M,f,D", [(100, 30, 5, 32), (40, 12, 15, 7),
                                     (60, 200, 4, 16)])
def test_agg_gradient_matches_jax_grad(N, M, f, D):
    h, nbr, valid = agg_inputs(N + f, N, M, f, D)
    g = np.random.default_rng(2).normal(size=(M, D)).astype(np.float32)
    want = jax.grad(j_agg_loss)(jnp.asarray(h), jnp.asarray(nbr),
                                jnp.asarray(valid), jnp.asarray(g))
    th = t(h).requires_grad_()
    out = sage_agg.sage_agg(th, t(nbr), t(valid))
    got, = torch.autograd.grad(out, th, grad_outputs=t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GTOL)


@pytest.mark.parametrize("valid_last", [True, False])
def test_agg_gradient_drops_out_of_range_like_jax_grad(valid_last):
    """An index past the last row: the forward reads the last row (jnp's
    gather clamps), the gradient adds nothing for it (the gather's
    gradient drops out-of-range indices), so the last row gets only its
    in-range slots' share.  With the last row valid, row 3 (all past the
    end) has six included slots in the forward and none in the
    gradient."""
    N, M, f, D = 40, 12, 6, 7
    h, nbr, valid = agg_inputs(9, N, M, f, D)
    valid[N - 1] = valid_last
    nbr[2] = [N - 1, N, N + 3, -1, 5, N + 40]       # past the end, mixed
    nbr[3] = N + 1                                  # only past the end
    g = np.random.default_rng(4).normal(size=(M, D)).astype(np.float32)
    want = jax.grad(j_agg_loss)(jnp.asarray(h), jnp.asarray(nbr),
                                jnp.asarray(valid), jnp.asarray(g))
    th = t(h).requires_grad_()
    out = sage_agg.sage_agg(th, t(nbr), t(valid))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        j_ref.sage_agg_ref(jnp.asarray(h), jnp.asarray(nbr),
                           jnp.asarray(valid))), **TOL)
    got, = torch.autograd.grad(out, th, grad_outputs=t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GTOL)


def test_agg_backward_only_where_h_needs_a_gradient():
    h, nbr, valid = agg_inputs(0, 30, 10, 4, 8)
    w = torch.ones(8, 8, requires_grad=True)
    before = sage_agg.sage_agg_bwd.launches
    calls = []
    orig = ref.sage_agg_bwd_ref
    try:
        sage_agg.sage_agg_bwd_ref = lambda *a: calls.append(1) or orig(*a)
        (sage_agg.sage_agg(t(h), t(nbr), t(valid)) @ w).sum().backward()
    finally:
        sage_agg.sage_agg_bwd_ref = orig
    assert not calls and w.grad is not None
    assert sage_agg.sage_agg_bwd.launches == before


def test_training_wrappers_refuse_other_devices():
    m = torch.device("meta")
    e = lambda *s, **k: torch.empty(*s, device=m, **k)  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        update_fused.update_fused_fwd(e(4, 3), e(4, 3), e(3, 5), e(3, 5),
                                      e(5))
    with pytest.raises(ValueError, match="unsupported device"):
        update_fused.update_fused_bwd(e(4, 5), e(4, 5))
    with pytest.raises(ValueError, match="unsupported device"):
        sage_agg.sage_agg_fwd(e(4, 3), e(2, 2, dtype=torch.int32),
                              e(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="unsupported device"):
        sage_agg.sage_agg_bwd(e(2, 3), e(2, 2, dtype=torch.int32),
                              e(4, dtype=torch.bool), e(2), 4)
