"""The plain versions of kernels F, H, C and A on infinite, NaN and
near-``FLT_MAX`` inputs (``repro_torch/kernels/nonfinite.py``) against the
reference: ``jax.vjp`` of its jnp AGG and GAT AGG (F and H) and its jnp
UPDATE and serve layer (C and A).  The non-finite values must lie exactly
where the reference's are, the finite ones within float32 rounding; the
card's tests hold the kernels to these plain versions on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import nonfinite, ref


def nan_close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    return (got.shape == want.shape
            and np.array_equal(np.isnan(got), np.isnan(want))
            and np.array_equal(got[np.isinf(want)], want[np.isinf(want)])
            and bool(np.isfinite(got[fin]).all())
            and bool((np.abs(got[fin] - want[fin])
                      <= rtol * np.maximum(np.abs(want[fin]), 1.0)).all()))


def t(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize("N,M,f,D", [(100, 30, 5, 32), (300, 37, 7, 6),
                                     (60, 40, 1, 8)])
def test_agg_gradient_is_the_reference(N, M, f, D):
    """F's plain version: a masked slot inside [0, N) adds 0 * g at its
    row (a pad at row 0), an index past N adds nothing, as the reference's
    autodiff of its masked mean gives."""
    c = nonfinite.agg_case(N + D, N, M, f, D)
    _, vjp = jax.vjp(lambda h: jref.sage_agg_ref(
        h, jnp.asarray(c["nbr_idx"]), jnp.asarray(c["src_valid"])),
        jnp.zeros((N, D), jnp.float32))
    want = np.asarray(vjp(jnp.asarray(c["g"]))[0])
    got = ref.sage_agg_bwd_ref(t(c["g"]), t(c["nbr_idx"]),
                               t(c["src_valid"]), t(c["cnt"]), N)
    assert nan_close(got.numpy(), want)
    assert np.isnan(want[0]).all() and (~np.isfinite(want)).sum() > D


@pytest.mark.parametrize("N,M,f,H,dh", [(80, 20, 4, 2, 8),
                                        (120, 30, 12, 1, 5)])
@pytest.mark.parametrize("kind", nonfinite.GAT_KINDS)
def test_gat_gradient_is_the_reference(N, M, f, H, dh, kind):
    """H's plain version: dz, de_u and de_v as the reference's autodiff of
    its jnp GAT AGG gives them, on non-finite g, z rows at masked, padded
    and kept sources, and a NaN softmax."""
    c = nonfinite.gat_case(N + f + H, N, M, f, H, dh, kind)
    nbr, valid = jnp.asarray(c["nbr_idx"]), jnp.asarray(c["src_valid"])
    _, vjp = jax.vjp(lambda z, eu, ev: jref.gat_edge_ref(z, eu, ev, nbr,
                                                         valid),
                     *(jnp.asarray(c[k]) for k in ("z", "e_u", "e_v")))
    want = vjp(jnp.asarray(c["g"].reshape(M, H, dh)))
    got = ref.gat_edge_bwd_ref(*(t(c[k]) for k in (
        "g", "z", "e_u", "e_v", "nbr_idx", "src_valid")))
    for a, b in zip(got, want):
        assert nan_close(a.numpy(), np.asarray(b))
    assert any((~np.isfinite(np.asarray(b))).any() for b in want)


@pytest.mark.parametrize("relu,dropout", [(True, 0.0), (True, 0.5),
                                          (False, 0.0)])
@pytest.mark.parametrize("N,C,K", [(300, 96, 130), (64, 32, 40)])
def test_update_is_the_reference(N, C, K, relu, dropout):
    """C's plain version: +-inf inputs, near-FLT_MAX ones (finite and
    overflowing products) and inf x 0 give the reference's float32
    product's +-inf and NaN."""
    c = nonfinite.update_case(N + K, N, C, K)
    want = jref.fused_update_ref(*(jnp.asarray(c[k]) for k in (
        "agg", "self_h", "wn", "ws", "b")), relu=relu, dropout=dropout,
        seed=jnp.uint32(9))
    got = ref.fused_update_ref(*(t(c[k]) for k in (
        "agg", "self_h", "wn", "ws", "b")), relu=relu, dropout=dropout,
        seed=9)
    assert nan_close(got.numpy(), np.asarray(want))
    assert (~np.isfinite(np.asarray(want))).any()


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("N,M,f,D,K", [(300, 37, 7, 24, 47),
                                       (120, 64, 3, 8, 16)])
def test_serve_layer_is_the_reference(N, M, f, D, K, relu):
    """A's plain version: the reference's jnp serve layer's +-inf and NaN
    on infinite and near-FLT_MAX rows (kept, masked, the pads' row 0)."""
    c = nonfinite.serve_case(N + K, N, M, f, D, K)
    p = {k: jnp.asarray(c[k]) for k in ("wn", "ws", "b")}
    want = jref.serve_layer_ref(p, jnp.asarray(c["h_src"]),
                                jnp.asarray(c["nbr_idx"]),
                                jnp.asarray(c["src_valid"]), relu=relu)
    got = ref.serve_layer_ref(*(t(c[k]) for k in (
        "h_src", "nbr_idx", "src_valid", "wn", "ws", "b")), relu=relu)
    assert nan_close(got.numpy(), np.asarray(want))
    assert (~np.isfinite(np.asarray(want))).any()
