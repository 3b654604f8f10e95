"""The port's GAT against the reference, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``.  On the
CPU the GAT AGG wrappers run their plain versions
(``kernels/ref.py:gat_edge_ref``/``gat_edge_bwd_ref``).

Tolerances:
- the forward is held against the Pallas kernel in interpret mode (as
  ``tests/test_kernels.py`` runs it), against ``repro.kernels.ref`` and
  against the offline engine's ``_gat_chunk`` at 1e-5 (atol and rtol):
  torch and XLA sum float32 in other orders;
- the backward is held against ``jax.grad`` of the reference's jnp
  function at 1e-5, since the Pallas kernel cannot be differentiated;
- the model's loss within 1e-5 relative and its parameter gradients at
  rtol 1e-4 / atol 1e-5, as the GraphSAGE model's in
  ``tests/test_torch_train.py``: the products of the gradient sum over
  hundreds of rows in another order.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import ref as j_ref
from repro.models.gnn import gat as j_gat
from repro.pipeline.vectorized_sampler import \
    sample_blocks_vectorized as j_sample
from repro.serve.gnn.offline import _gat_chunk as j_gat_chunk
from repro_torch.configs.gnn import small_gnn_config
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.kernels import gat_edge, ref
from repro_torch.models.gnn import build_model
from repro_torch.models.gnn.gat import GAT, init_params_np, layer_shapes

TOL = dict(atol=1e-5, rtol=1e-5)
GTOL = dict(atol=1e-5, rtol=1e-4)
CPU = torch.device("cpu")
t = torch.as_tensor


def gat_inputs(seed, N, M, f, H, dh):
    """z, e_u, e_v, nbr, valid with -1 pads, indices past N (clamped), an
    all-masked row, a row whose sources are all invalid, and one included
    slot whose score is exactly 0."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(N, H, dh)).astype(np.float32)
    eu = rng.normal(size=(N, H)).astype(np.float32)
    ev = rng.normal(size=(N, H)).astype(np.float32)
    nbr = rng.integers(-1, N + 3, (M, f)).astype(np.int32)
    valid = rng.random(N) > 0.15
    nbr[0] = -1
    nbr[1, :] = -1
    nbr[1, 0] = np.flatnonzero(~valid)[0] if (~valid).any() else -1
    nbr[2, 0] = np.flatnonzero(valid[:N - 1])[0]
    eu[nbr[2, 0], 0] = -ev[2, 0]                   # s = 0 exactly
    return z, eu, ev, nbr, valid


SHAPES = [(80, 20, 4, 2, 8), (200, 50, 7, 4, 16), (64, 64, 3, 8, 8),
          (257, 61, 13, 3, 20), (300, 40, 40, 2, 6)]


@pytest.mark.parametrize("N,M,f,H,dh", SHAPES)
def test_gat_edge_forward_matches_pallas_and_ref(N, M, f, H, dh):
    z, eu, ev, nbr, valid = gat_inputs(N + f, N, M, f, H, dh)
    before = gat_edge.gat_edge_fwd.launches
    got = gat_edge.gat_edge_fwd(t(z), t(eu), t(ev), t(nbr), t(valid)).numpy()
    assert gat_edge.gat_edge_fwd.launches == before   # plain version on CPU
    j = [jnp.asarray(x) for x in (z, eu, ev, nbr, valid)]
    pallas = np.asarray(ops.gat_edge_aggregate(*j, interpret=True))
    jref = np.asarray(j_ref.gat_edge_ref(*j))
    assert got.shape == (M, H * dh)
    np.testing.assert_allclose(got, pallas.reshape(M, -1), **TOL)
    np.testing.assert_allclose(got, jref.reshape(M, -1), **TOL)
    assert not got[:2].any()                       # all-masked rows
    assert np.abs(got[2:]).max() > 0


def test_gat_edge_softmax_normalized():
    """With z = 1 every row that has an included slot sums its weights to
    exactly the head count (as tests/test_kernels.py checks the kernel)."""
    _, eu, ev, nbr, valid = gat_inputs(0, 90, 30, 6, 3, 4)
    out = gat_edge.gat_edge_fwd(torch.ones(90, 3, 4), t(eu), t(ev), t(nbr),
                                t(valid)).numpy()
    idx = np.clip(nbr, 0, 89)
    some = ((nbr >= 0) & valid[idx]).any(1)
    np.testing.assert_allclose(out[some].reshape(-1, 3, 4), 1.0, atol=1e-6)
    assert not out[~some].any()


@pytest.mark.parametrize("N,M,f,H,dh", [(120, 48, 9, 4, 8), (60, 31, 77, 1,
                                                             5)])
def test_gat_edge_dst_idx_matches_offline_chunk(N, M, f, H, dh):
    """The offline form: dst rows by id (clipped), every source valid."""
    z, eu, ev, nbr, _ = gat_inputs(N * f, N, M, f, H, dh)
    nbr = np.minimum(nbr, N - 1)
    dst = np.random.default_rng(1).integers(-2, N + 2, M).astype(np.int32)
    dst[:3] = [-1, N - 1, N + 5]
    valid = np.ones(N, bool)
    got = gat_edge.gat_edge_fwd(t(z), t(eu), t(ev), t(nbr), t(valid),
                                t(dst)).numpy()
    want = np.asarray(j_gat_chunk(jnp.asarray(z), jnp.asarray(eu),
                                  jnp.asarray(ev), jnp.asarray(dst),
                                  jnp.asarray(nbr)))
    np.testing.assert_allclose(got, want, **TOL)


def j_edge_loss(z, eu, ev, nbr, valid, g):
    return jnp.sum(j_ref.gat_edge_ref(z, eu, ev, nbr, valid)
                   .reshape(g.shape) * g)


@pytest.mark.parametrize("N,M,f,H,dh", SHAPES)
def test_gat_edge_gradient_matches_jax_grad(N, M, f, H, dh):
    z, eu, ev, nbr, valid = gat_inputs(N * H, N, M, f, H, dh)
    g = np.random.default_rng(2).normal(size=(M, H * dh)).astype(np.float32)
    want = jax.grad(j_edge_loss, argnums=(0, 1, 2))(
        *[jnp.asarray(x) for x in (z, eu, ev, nbr, valid, g)])
    got = gat_edge.gat_edge_bwd(t(g), t(z), t(eu), t(ev), t(nbr), t(valid))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # through autograd: the same gradients
    tz, teu, tev = (t(x).requires_grad_() for x in (z, eu, ev))
    out = gat_edge.gat_edge_aggregate(tz, teu, tev, t(nbr), t(valid))
    auto = torch.autograd.grad(out, (tz, teu, tev), grad_outputs=t(g))
    for a, b in zip(auto, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_gat_edge_dst_idx_gradient_matches_jax_grad():
    N, M, f, H, dh = 70, 40, 12, 2, 6
    z, eu, ev, nbr, _ = gat_inputs(5, N, M, f, H, dh)
    nbr = np.minimum(nbr, N - 1)
    dst = np.random.default_rng(3).integers(-2, N + 2, M).astype(np.int32)
    dst[:4] = [-1, 5, 5, N + 1]                   # clipped and repeated rows
    g = np.random.default_rng(4).normal(size=(M, H * dh)).astype(np.float32)

    def loss(z, eu, ev):
        return jnp.sum(j_gat_chunk(z, eu, ev, jnp.asarray(dst),
                                   jnp.asarray(nbr)) * jnp.asarray(g))
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(z), jnp.asarray(eu),
                                              jnp.asarray(ev))
    got = gat_edge.gat_edge_bwd(t(g), t(z), t(eu), t(ev), t(nbr),
                                torch.ones(N, dtype=torch.bool), t(dst))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_gat_plain_versions_in_slot_blocks(monkeypatch):
    """One slot per block (as at training layer 0 on the card) gives what
    one block of all slots gives."""
    z, eu, ev, nbr, valid = gat_inputs(9, 120, 40, 11, 3, 8)
    g = np.random.default_rng(9).normal(size=(40, 24)).astype(np.float32)
    args = [t(x) for x in (z, eu, ev, nbr, valid)]
    whole = [ref.gat_edge_ref(*args)] + list(ref.gat_edge_bwd_ref(t(g),
                                                                   *args))
    orig = ref._slot_blocks
    monkeypatch.setattr(ref, "_slot_blocks",
                        lambda M, f, w: orig(M, f, w, limit=1))
    assert len(list(ref._slot_blocks(40, 11, 24))) == 11
    split = [ref.gat_edge_ref(*args)] + list(ref.gat_edge_bwd_ref(t(g),
                                                                   *args))
    for a, b in zip(split, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_gat_edge_backward_only_where_needed():
    z, eu, ev, nbr, valid = gat_inputs(0, 30, 10, 4, 2, 4)
    calls = []
    orig = ref.gat_edge_bwd_ref
    try:
        gat_edge.gat_edge_bwd_ref = lambda *a: calls.append(1) or orig(*a)
        w = torch.ones(8, 3, requires_grad=True)
        (gat_edge.gat_edge_aggregate(t(z), t(eu), t(ev), t(nbr), t(valid))
         @ w).sum().backward()
        assert not calls and w.grad is not None
        tz = t(z).requires_grad_()
        gat_edge.gat_edge_aggregate(tz, t(eu), t(ev), t(nbr),
                                    t(valid)).sum().backward()
        assert calls == [1] and tz.grad is not None
    finally:
        gat_edge.gat_edge_bwd_ref = orig


def test_gat_wrappers_refuse_other_devices():
    m = torch.device("meta")
    e = lambda *s, **k: torch.empty(*s, device=m, **k)  # noqa: E731
    args = (e(6, 2, 4), e(6, 2), e(6, 2), e(3, 2, dtype=torch.int32),
            e(6, dtype=torch.bool))
    with pytest.raises(ValueError, match="unsupported device"):
        gat_edge.gat_edge_fwd(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        gat_edge.gat_edge_bwd(e(3, 8), *args)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_gat_init_params_scales_and_leaf_order():
    shapes = layer_shapes(64, 32, 10, 3, 4)
    assert shapes == [(64, 4, 32), (128, 4, 32), (128, 1, 10)]
    p = init_params_np(0, shapes)
    for (din, H, dh), layer in zip(shapes, p["layers"]):
        assert layer["w"].shape == (din, H, dh)
        assert layer["w"].dtype == np.float32
        assert np.std(layer["w"]) == pytest.approx((2 / din) ** 0.5, rel=0.1)
        assert not layer["b"].any() and layer["b"].shape == (H, dh)
    big = init_params_np(1, [(8, 16, 64)])["layers"][0]
    for k in ("a_u", "a_v"):
        assert np.std(big[k]) == pytest.approx(64 ** -0.5, rel=0.1)
    m = GAT(shapes).params_from_jax(p)
    leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(jnp.asarray, p))
    got = m.parameter_list()
    assert len(got) == len(leaves) == 12
    for a, b in zip(got, leaves):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert all(q.requires_grad for q in m.parameters())
    with pytest.raises(ValueError):
        GAT(shapes[:2]).params_from_jax(p)
    # the reference's own init has the same tree and shapes
    jp = j_gat.init_params(jax.random.key(0), 64, 32, 10, 3, 4)
    assert jax.tree_util.tree_structure(jp) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(jnp.asarray, p))
    GAT(shapes).params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def test_build_model_dispatch_and_device_rule(monkeypatch):
    cfg = small_gnn_config("gat", feat_dim=16, num_classes=5, hidden_size=8)
    m = build_model(cfg, seed=3, device="cpu")
    assert isinstance(m, GAT) and m.shapes == [(16, 4, 8), (32, 1, 5)]
    assert m.layers[0].w.device == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(ValueError, match="unknown model"):
        build_model(small_gnn_config("gcn"), device="cpu")


@pytest.fixture(scope="module")
def sampled_part():
    return partition_graph(synthetic_graph(
        num_vertices=600, avg_degree=6, num_classes=5, feat_dim=16, seed=1),
        1).parts[0]


def model_inputs(part, layers, heads, hidden):
    fanouts = (3, 4, 5)[:layers]
    seeds = np.flatnonzero(part.train_mask)[:20]
    mb = j_sample(part, seeds, fanouts, np.random.default_rng(4), 24)
    shapes = layer_shapes(16, hidden, 5, layers, heads)
    h0 = part.features[np.maximum(mb.layer_nodes[0], 0)] \
        * mb.node_mask[0][:, None]
    return mb, shapes, h0


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("layers", [2, 3])
def test_gat_forward_matches_reference(sampled_part, layers, use_kernel):
    """Serving forward with a substituting halo hook; the reference's jnp
    path and its Pallas path (interpret mode)."""
    mb, shapes, h0 = model_inputs(sampled_part, layers, 2, 8)
    p = init_params_np(layers, shapes)
    rng = np.random.default_rng(1)
    subst = {k: (rng.random(len(mb.layer_nodes[k])) < 0.3,
                 rng.normal(size=(len(mb.layer_nodes[k]), 16))
                 .astype(np.float32)) for k in range(1, layers)}

    def hook_for(lib, asarray):
        def hook(k, h, valid):
            if k == 0:
                return h, valid
            hit, emb = (asarray(x) for x in subst[k])
            return lib.where(hit[:, None], emb, h), valid | hit
        return hook

    out, valid = GAT(shapes).params_from_jax(p)(
        t(h0), t(mb.node_mask[0]),
        {"nbr_idx": [t(x.astype(np.int32)) for x in mb.nbr_idx]},
        halo_hook=hook_for(torch, torch.as_tensor))
    jout, jvalid = j_gat.forward(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(h0),
        jnp.asarray(mb.node_mask[0]),
        {"nbr_idx": [jnp.asarray(x, jnp.int32) for x in mb.nbr_idx]},
        halo_hook=hook_for(jnp, jnp.asarray), use_kernel=use_kernel)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def masked_ce_jax(params, h0, valid0, blocks, seed_mask, labels, dropout):
    out, valid = j_gat.forward(params, h0, valid0, blocks, dropout=dropout,
                               seed=jnp.uint32(2 ** 32 - 1))
    B = labels.shape[0]
    logits = out[:B]
    lmask = seed_mask & valid[:B]
    logz = jax.scipy.special.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, labels[:, None], -1)[:, 0]
    return ((logz - gold) * lmask).sum() / jnp.maximum(lmask.sum(), 1)


@pytest.mark.parametrize("layers,dropout", [(2, 0.0), (2, 0.1), (3, 0.1)])
def test_gat_train_forward_and_grads_match_reference(sampled_part, layers,
                                                     dropout):
    mb, shapes, h0 = model_inputs(sampled_part, layers, 3, 8)
    p = init_params_np(7, shapes)
    want_loss, want_g = jax.value_and_grad(masked_ce_jax)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(h0),
        jnp.asarray(mb.node_mask[0]),
        {"nbr_idx": [jnp.asarray(x, jnp.int32) for x in mb.nbr_idx]},
        jnp.asarray(mb.seed_mask), jnp.asarray(mb.labels, jnp.int32),
        dropout)
    model = GAT(shapes).params_from_jax(p)
    out, valid = model.train_forward(
        t(h0), t(mb.node_mask[0]),
        {"nbr_idx": [t(x.astype(np.int32)) for x in mb.nbr_idx]},
        dropout=dropout, seed=2 ** 32 - 1)
    lmask = t(mb.seed_mask) & valid[:24]
    logits = out[:24]
    nll = (torch.logsumexp(logits, -1) - logits.gather(
        1, t(mb.labels)[:, None])[:, 0]) * lmask.float()
    loss = nll.sum() / lmask.sum().clamp_min(1)
    grads = torch.autograd.grad(loss, model.parameter_list())
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    leaves = jax.tree_util.tree_leaves(want_g)   # per layer: a_u, a_v, b, w
    assert len(leaves) == len(grads) == 4 * layers
    for a, b in zip(grads, leaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GTOL)
