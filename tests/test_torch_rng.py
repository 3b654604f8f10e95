"""The port's ``jax.random`` streams against jax, live, bit for bit.

* the AEP push selection's default uniforms
  (``train/gnn_trainer.py:default_push_uniforms``) against the
  reference's draw in ``repro/comm/engine.py:select_push``, and the hot
  tier's (``DistTrainer.hot_uniforms``) against ``select_hot_push``'s;
* ``split``, ``random_bits`` and ``uniform`` of ``pipeline/threefry.py``;
* ``models/gnn/init.py``: ``erf_inv_f32`` on every float32 a normal can
  draw, ``normal``, and the GraphSAGE and GAT initial weights against
  ``repro``'s ``init_model_params(jax.random.key(seed), cfg)`` at the
  paper's widths and at narrow ones, as ``from_config`` and the launchers
  build them.

Nothing here has a tolerance: every float is compared by its bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import gnn as j_cfg
from repro.train.gnn_trainer import init_model_params
from repro_torch.configs import gnn as t_cfg
from repro_torch.models.gnn import build_model, init
from repro_torch.models.gnn.gat import init_params_np as gat_params_np
from repro_torch.models.gnn.gat import layer_shapes
from repro_torch.models.gnn.graphsage import init_params_np, layer_dims
from repro_torch.pipeline import threefry
from repro_torch.train.gnn_trainer import default_push_uniforms

CPU = torch.device("cpu")


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# the AEP push uniforms
# ---------------------------------------------------------------------------
def jax_push_uniforms(seed, me, shape, base=7):
    """``repro/comm/engine.py:select_push``'s draw (``seed`` the step's
    uint32, ``me`` the rank's axis index)."""
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(base), jnp.uint32(seed)), jnp.int32(me))
    return np.asarray(jax.random.uniform(key, shape, minval=1e-6,
                                         maxval=1.0))


@pytest.mark.parametrize("seed", [0, 3, 2 ** 32 - 1])
@pytest.mark.parametrize("shape", [(4, 300), (4, 1777), (1, 10)],
                         ids=["4x300", "4x1777", "1x10"])
def test_push_uniforms_match_jax(shape, seed):
    draw = default_push_uniforms(CPU)
    for me in range(shape[0]):
        got = draw(seed, me, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(bits(got.numpy()),
                                      bits(jax_push_uniforms(seed, me, shape)))


def test_push_uniforms_base_seed_is_a_parameter():
    """The hot tier's push draws from ``PRNGKey(11)`` with the same rule."""
    got = default_push_uniforms(CPU, base_seed=11)(5, 2, (4, 513))
    np.testing.assert_array_equal(bits(got.numpy()),
                                  bits(jax_push_uniforms(5, 2, (4, 513), 11)))
    assert not np.array_equal(got.numpy(), jax_push_uniforms(5, 2, (4, 513)))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
def test_hot_push_uniforms_match_jax(seed):
    """``repro/comm/engine.py:select_hot_push``'s draw, one uniform per
    layer-0 row from ``PRNGKey(11)``, as the trainer's default
    ``hot_uniforms`` gives it."""
    from repro_torch.configs.gnn import small_gnn_config
    from repro_torch.train.gnn_trainer import DistTrainer
    tr = DistTrainer(small_gnn_config("graphsage"), 4, device="cpu")
    for me, n0 in enumerate((1152, 1777, 10, 300)):
        got = tr.hot_uniforms(seed, me, (n0,))
        assert got.dtype == torch.float32 and tuple(got.shape) == (n0,)
        np.testing.assert_array_equal(
            bits(got.numpy()), bits(jax_push_uniforms(seed, me, (n0,), 11)))


# ---------------------------------------------------------------------------
# split, bits, uniform
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1])
def test_split_matches_jax(seed):
    for num in (2, 3, 4, 9):
        want = np.asarray(jax.random.key_data(
            jax.random.split(jax.random.key(seed), num)))
        assert threefry.split(threefry.key(seed), num) == \
            [tuple(int(x) for x in k) for k in want]


@pytest.mark.parametrize("shape", [(), (7,), (33, 5), (2, 3, 129)],
                         ids=["scalar", "7", "33x5", "2x3x129"])
def test_bits_and_uniform_match_jax(shape):
    k = threefry.fold_in(threefry.key(9), 4)
    jk = jax.random.fold_in(jax.random.key(9), 4)
    np.testing.assert_array_equal(
        threefry.random_bits(k, shape).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (1e-6, 1.0), (-3.0, 2.5)):
        np.testing.assert_array_equal(
            bits(threefry.uniform(k, shape, lo, hi).numpy()),
            bits(jax.random.uniform(jk, shape, minval=lo, maxval=hi)))


# ---------------------------------------------------------------------------
# the normal and the initial weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("part", range(4))
def test_erf_inv_matches_xla_on_every_draw(part):
    """``sqrt(2) * erf_inv(u)`` on every uniform ``jax.random.normal`` can
    draw: the 2^23 mantissas ``f``, ``u = max(lo, 2 f + lo)`` with ``lo``
    = nextafter(-1, 0), a quarter per case."""
    n = 1 << 21
    m = np.arange(part * n, (part + 1) * n, dtype=np.uint32)
    f = (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0), dtype=np.float32)
    u = np.maximum(lo, f * np.float32(2) + lo)
    want = jax.jit(lambda x: np.float32(np.sqrt(2)) * lax.erf_inv(x))(u)
    got = init.erf_inv_f32(u) * np.float32(np.sqrt(2))
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1])
def test_normal_matches_jax(seed):
    for shape in ((128, 256), (256, 4, 256), (5,)):
        np.testing.assert_array_equal(
            bits(init.normal(threefry.key(seed), shape)),
            bits(jax.random.normal(jax.random.key(seed), shape, jnp.float32)))


CONFIGS = {
    "graphsage-papers100m": (t_cfg.GRAPHSAGE_PAPERS100M,
                             j_cfg.GRAPHSAGE_PAPERS100M),
    "gat-papers100m": (t_cfg.GAT_PAPERS100M, j_cfg.GAT_PAPERS100M),
    "graphsage-narrow": (t_cfg.small_gnn_config("graphsage", feat_dim=24,
                                                num_classes=6),
                         j_cfg.small_gnn_config("graphsage", feat_dim=24,
                                                num_classes=6)),
    "gat-narrow": (t_cfg.small_gnn_config("gat", feat_dim=24, num_classes=6,
                                          hidden_size=16),
                   j_cfg.small_gnn_config("gat", feat_dim=24, num_classes=6,
                                          hidden_size=16)),
}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_from_config_weights_are_the_reference_launchers(name, seed):
    """``build_model(cfg, seed)`` (and so ``from_config``, ``init_state``
    and all three launchers) against the reference's
    ``init_model_params(jax.random.key(seed), cfg)``."""
    tc, jc = CONFIGS[name]
    model = build_model(tc, seed=seed, device=CPU)
    want = init_model_params(jax.random.key(seed), jc)["layers"]
    assert len(model.layers) == len(want)
    for layer, w in zip(model.layers, want):
        assert sorted(dict(layer.named_parameters())) == sorted(w)
        for n, v in w.items():
            np.testing.assert_array_equal(
                bits(getattr(layer, n).detach().numpy()), bits(v),
                err_msg=f"{name} {n}")


def test_numpy_init_stays_an_option():
    cfg = t_cfg.small_gnn_config("graphsage", feat_dim=24, num_classes=6)
    got = build_model(cfg, seed=4, device=CPU, init="numpy")
    want = init_params_np(4, layer_dims(24, cfg.hidden_size, 6,
                                        cfg.num_layers))
    for layer, w in zip(got.layers, want["layers"]):
        np.testing.assert_array_equal(layer.wn.detach().numpy(), w["wn"])
    gcfg = t_cfg.small_gnn_config("gat", feat_dim=24, num_classes=6)
    gat = build_model(gcfg, seed=4, device=CPU, init="numpy")
    want = gat_params_np(4, layer_shapes(24, gcfg.hidden_size, 6,
                                         gcfg.num_layers, gcfg.num_heads))
    np.testing.assert_array_equal(gat.layers[0].w.detach().numpy(),
                                  want["layers"][0]["w"])
    with pytest.raises(ValueError, match="unknown init"):
        build_model(cfg, device=CPU, init="xavier")
