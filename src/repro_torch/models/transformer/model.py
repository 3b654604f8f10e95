"""Model assembly for the assigned architectures (port of
``repro/models/transformer/model.py``).

A model is a list of *segments*; each segment is a repeating *unit* (the
config's block pattern) applied ``count`` times, its params stacked over
the units (``seg{i}/b{j}/<leaf>`` of shape ``[count, ...]``, the
reference's tree, so weights carry across by name).  The reference scans
the unit over the stack; here a Python loop takes unit u's slice.

Four entry modes share the block implementations:
  train   — full-sequence forward, no caches (each unit rematerialised
            in the backward under ``cfg.remat``)
  encode  — encoder stack (bidirectional), audio enc-dec only
  prefill — full-sequence forward that also EMITS per-layer caches
  decode  — one token in, caches consumed and updated IN PLACE

Caches mirror the reference's: a list over segments of ``{"b{j}": ...}``
with every leaf stacked over units (``[count, B, ...]``): attention
``{"kv": KVCache, ["xk", "xv"]}``, mLSTM ``((C, n, m), conv_buf)``, sLSTM
``(c, n, h, m)``, RG-LRU ``(h, conv_buf)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import base as cfgbase
from repro_torch.models.normal import F32, normal
from repro_torch.models.transformer import blocks as blk
from repro_torch.models.transformer import rglru as rglru_lib
from repro_torch.models.transformer import xlstm as xlstm_lib
from repro_torch.models.transformer.attention import KVCache, row_positions
from repro_torch.models.transformer.xlstm import mul_weak, rms_norm
from repro_torch.pipeline import threefry

Params = Any
LOGIT_CHUNK = 32768             # vocab columns widened to float32 at a time


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# trees (nested dicts, lists, tuples and KVCaches of tensors)
# ---------------------------------------------------------------------------
def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, KVCache):
        return KVCache(*(tree_map(fn, getattr(tree, f), *(getattr(r, f)
                                                            for r in rest))
                         for f in ("k", "v", "pos")), ring=tree.ring)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the reference's order (``jax.tree_util.tree_leaves``:
    dict keys sorted, a KVCache's k, v, pos)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    if isinstance(tree, KVCache):
        return [tree.k, tree.v, tree.pos]
    return [tree]


def params_from_reference(tree, device=None, dtype=None) -> Params:
    """The reference's params (nested dicts of numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as the port's."""
    return tree_map(lambda a: torch.as_tensor(np.array(a)).to(
        device=device, dtype=dtype or torch.float32), tree)


def adam_state_from_reference(opt_state, device=None):
    """The reference's Adam state (``{"mu", "nu", "step"}`` with numpy
    leaves, e.g. ``jax.tree_util.tree_map(np.asarray, opt_state)``) as the
    port's ``AdamState``: the moments as float32 lists in the reference's
    leaf order, the step an int."""
    from repro_torch.train.optimizer import AdamState
    moments = lambda t: [torch.as_tensor(np.array(a)).to(  # noqa: E731
        device=device, dtype=torch.float32) for a in tree_leaves(t)]
    return AdamState(mu=moments(opt_state["mu"]), nu=moments(opt_state["nu"]),
                     step=int(np.asarray(opt_state["step"])))


def cache_from_reference(caches, device=None):
    """The reference's caches (numpy leaves; its ``KVCache`` objects, the
    cross-attention ``xk``/``xv``, the mLSTM ``((C, n, m), conv_buf)``, the
    sLSTM ``(c, n, h, m)`` and the RG-LRU ``(h, conv_buf)``) as the
    port's."""
    if isinstance(caches, dict):
        return {k: cache_from_reference(v, device) for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return type(caches)(cache_from_reference(c, device) for c in caches)
    if hasattr(caches, "pos") and hasattr(caches, "ring"):
        t = lambda a: torch.as_tensor(np.array(a), device=device)  # noqa: E731
        return KVCache(t(caches.k), t(caches.v), t(caches.pos),
                       ring=bool(caches.ring))
    return torch.as_tensor(np.array(caches), device=device)


# ---------------------------------------------------------------------------
# structure and initial weights
# ---------------------------------------------------------------------------
def segments_spec(cfg) -> list[tuple[tuple[str, ...], int]]:
    segs = [(tuple(cfg.pattern), cfg.num_units)]
    if cfg.remainder:
        segs.append((tuple(cfg.remainder), 1))
    return segs


@dataclasses.dataclass(frozen=True)
class Normal:
    """``jax.random.normal(keys[key], shape) * scale`` of the block's keys."""
    key: int
    shape: tuple
    scale: float


@dataclasses.dataclass(frozen=True)
class Const:
    shape: tuple
    make: Callable[[], np.ndarray]        # float32


@dataclasses.dataclass(frozen=True)
class Sub:
    """A sub-tree drawn from ``split(keys[key], n)``."""
    key: int
    n: int
    leaves: dict


def _ones(*shape):
    return Const(shape, lambda: np.ones(shape, F32))


def _zeros(*shape):
    return Const(shape, lambda: np.zeros(shape, F32))


def _lam(w: int) -> np.ndarray:
    """RG-LRU's Lambda, so that a^c lies in [0.9, 0.999] (griffin init).
    A closed form, evaluated in float64: within 1e-5 relative of the
    reference's float32 (whose own ``expm1`` is that far off)."""
    lin = np.linspace(np.float64(F32(0.9)), np.float64(F32(0.999)), w)
    return np.log(np.expm1(-np.log(lin) / rglru_lib._C)).astype(F32)


def block_spec(cfg, block_type: str, cross: bool = False) -> Sub:
    """A block's leaves as its ``init_*`` in the reference draws them."""
    d = cfg.d_model
    if block_type in cfgbase.ATTENTION_BLOCKS:
        H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        s, so = d ** -0.5, (H * dh) ** -0.5
        p = {"ln1": _ones(d), "wq": Normal(0, (d, H, dh), s),
             "wk": Normal(1, (d, KV, dh), s), "wv": Normal(2, (d, KV, dh), s),
             "wo": Normal(3, (H, dh, d), so), "ln2": _ones(d)}
        if cfg.use_bias:
            p.update(bq=_zeros(H, dh), bk=_zeros(KV, dh), bv=_zeros(KV, dh))
        if block_type in cfgbase.MOE_BLOCKS:
            f, e = cfg.d_ff, cfg.num_experts
            p["moe"] = Sub(4, 4, {
                "router": Normal(0, (d, e), d ** -0.5),
                "w_in": Normal(1, (e, d, f), d ** -0.5),
                "w_gate": Normal(2, (e, d, f), d ** -0.5),
                "w_out": Normal(3, (e, f, d), f ** -0.5)})
        else:
            f = cfg.d_ff
            p.update(w_in=Normal(5, (d, f), s), w_gate=Normal(6, (d, f), s),
                     w_out=Normal(7, (f, d), f ** -0.5))
        if cross:
            p.update(lnx=_ones(d), xwq=Normal(8, (d, H, dh), s),
                     xwk=Normal(9, (d, KV, dh), s),
                     xwv=Normal(10, (d, KV, dh), s),
                     xwo=Normal(11, (H, dh, d), so))
        return Sub(0, 12, p)
    if block_type == cfgbase.MLSTM:
        inner = int(cfg.mlstm_proj_factor * d)
        H = cfg.num_heads
        dh = inner // H
        s_d, s_i = d ** -0.5, inner ** -0.5
        return Sub(0, 9, {
            "ln": _ones(d), "w_up": Normal(0, (d, inner), s_d),
            "w_z": Normal(1, (d, inner), s_d),
            "conv_w": Normal(2, (cfg.conv1d_width, inner), 0.3),
            "w_q": Normal(3, (inner, H, dh), s_i),
            "w_k": Normal(4, (inner, H, dh), s_i),
            "w_v": Normal(5, (inner, H, dh), s_i),
            "w_i": Normal(6, (inner, H), s_i), "w_f": Normal(7, (inner, H), s_i),
            "b_f": Const((H,), lambda: np.full((H,), 3.0, F32)),
            "gn": _ones(inner), "w_down": Normal(8, (inner, d), s_i)})
    if block_type == cfgbase.SLSTM:
        H = cfg.num_heads
        dh = d // H
        s = d ** -0.5
        return Sub(0, 4, {
            "ln": _ones(d), "w_gates": Normal(0, (d, 4 * d), s),
            "r_gates": Normal(1, (H, dh, 4 * dh), dh ** -0.5),
            "b_gates": Const((4 * d,), lambda: np.concatenate(
                [np.zeros(2 * d, F32), np.full(d, 3.0, F32),
                 np.zeros(d, F32)])),
            "gn": _ones(d), "w_up": Normal(2, (d, 2 * d), s),
            "w_down": Normal(3, (d, d), s)})
    if block_type == cfgbase.RGLRU:
        w = cfg.rnn_width
        s = d ** -0.5
        return Sub(0, 6, {
            "ln": _ones(d), "w1": Normal(0, (d, w), s),
            "w2": Normal(1, (d, w), s),
            "conv_w": Normal(2, (cfg.conv1d_width, w), 0.3),
            "w_a": Normal(3, (w, w), w ** -0.5), "b_a": _zeros(w),
            "w_x": Normal(4, (w, w), w ** -0.5), "b_x": _zeros(w),
            "lam": Const((w,), lambda: _lam(w)),
            "w_out": Normal(5, (w, d), w ** -0.5)})
    raise ValueError(block_type)


Draw = Callable[[threefry.Key, tuple], torch.Tensor]


def _threefry_draw(device):
    def draw(key, shape):
        return torch.from_numpy(normal(key, shape)).to(device)
    return draw


def _value(leaf, keys, draw: Draw) -> torch.Tensor:
    if isinstance(leaf, Normal):
        return draw(keys[leaf.key], leaf.shape) * float(F32(leaf.scale))
    return torch.from_numpy(leaf.make())


def _fill(spec: Sub, key, draw: Draw, out: dict, u: int, device, dtype):
    """Draws unit u of a stacked sub-tree from ``key`` into ``out``."""
    keys = threefry.split(key, spec.n)
    for name, leaf in spec.leaves.items():
        if isinstance(leaf, Sub):
            _fill(leaf, keys[leaf.key], draw, out[name], u, device, dtype)
        else:
            out[name][u] = _value(leaf, keys, draw).to(device=device,
                                                       dtype=dtype)


def _alloc(spec: Sub, count: int, device, dtype) -> dict:
    return {name: (_alloc(leaf, count, device, dtype) if isinstance(leaf, Sub)
                   else torch.empty((count,) + tuple(leaf.shape),
                                    device=device, dtype=dtype))
            for name, leaf in spec.leaves.items()}


def _stack(pattern, count, key, cfg, cross, draw, device, dtype) -> dict:
    """``vmap(lambda k: _init_unit(k, cfg, pattern, cross))(split(key,
    count))``: with partitionable Threefry, unit u's draws are those of
    its own key (``tests/test_torch_lm_blocks.py`` shows the two equal)."""
    specs = [block_spec(cfg, bt, cross) for bt in pattern]
    out = {f"b{i}": _alloc(s, count, device, dtype)
           for i, s in enumerate(specs)}
    for u, ukey in enumerate(threefry.split(key, count)):
        bkeys = threefry.split(ukey, len(pattern))
        for i, s in enumerate(specs):
            _fill(s, bkeys[i], draw, out[f"b{i}"], u, device, dtype)
    return out


def init_params(seed: int, cfg, device=None, dtype=torch.float32) -> Params:
    """``M.init_params(jax.random.key(seed), cfg)`` of the reference, bit
    for bit (every leaf but RG-LRU's closed-form ``lam``, see
    :func:`_lam`), drawn on the host and moved to ``device`` in ``dtype``."""
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    return _build(seed, cfg, _threefry_draw(device), device, dtype)


def _build(seed: int, cfg, draw: Draw, device, dtype) -> Params:
    """The reference's parameter tree with each normal leaf ``draw(key,
    shape) * scale`` (float32 of ``shape``; ``key`` the reference's for
    that leaf)."""
    ks = threefry.split(threefry.key(seed), 8)
    d, V = cfg.d_model, cfg.vocab_size
    top = {"embed": Normal(0, (V, d), d ** -0.5), "final_ln": _ones(d)}
    if not cfg.tie_embeddings:
        top["unembed"] = Normal(1, (d, V), d ** -0.5)
    params = {name: _value(leaf, ks, draw).to(device=device, dtype=dtype)
              for name, leaf in top.items()}
    cross = cfg.is_encoder_decoder
    for si, (pattern, count) in enumerate(segments_spec(cfg)):
        params[f"seg{si}"] = _stack(pattern, count, ks[2 + si], cfg, cross,
                                    draw, device, dtype)
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "stack": _stack((cfgbase.ATTN,), cfg.num_encoder_layers, ks[6],
                            cfg, False, draw, device, dtype),
            "final_ln": torch.ones(d, device=device, dtype=dtype)}
    return params


class TransformerLM(nn.Module):
    """Owns a model's parameter tree (as nested ``ModuleDict`` /
    ``ParameterDict``, frozen for serving); its methods call the
    functions of this module on :attr:`params`."""

    def __init__(self, cfg, params: Params):
        super().__init__()
        self.cfg = cfg
        self.tree = _Tree(params)

    @property
    def params(self) -> Params:
        return _from_module(self.tree)

    def forward(self, tokens, extra=None, mode="train"):
        return forward(self.params, self.cfg, tokens, extra, mode)

    def decode_step(self, caches, token, pos, extra=None):
        return decode_step(self.params, self.cfg, caches, token, pos, extra)


class _Tree(nn.Module):
    """One level of a parameter tree: its tensors and its sub-trees."""

    def __init__(self, tree: dict):
        super().__init__()
        self.leaves = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in tree.items() if torch.is_tensor(v)})
        self.kids = nn.ModuleDict(
            {k: _Tree(v) for k, v in tree.items() if isinstance(v, dict)})


def _from_module(mod: _Tree) -> dict:
    out = dict(mod.leaves.items())
    out.update({k: _from_module(m) for k, m in mod.kids.items()})
    return out


def as_params(model: Union[Params, TransformerLM]) -> Params:
    return model.params if isinstance(model, TransformerLM) else model


# ---------------------------------------------------------------------------
# block dispatch
# ---------------------------------------------------------------------------
def _apply_block(bp, x, cfg, bt, positions, mode, cache, pos, enc_out,
                 causal=True):
    if bt in cfgbase.ATTENTION_BLOCKS:
        return blk.apply_attn_block(bp, x, cfg, bt, positions, mode,
                                    cache, pos, enc_out, causal=causal)
    if bt == cfgbase.MLSTM:
        return xlstm_lib.apply_mlstm_block(bp, x, cfg, cache, mode)
    if bt == cfgbase.SLSTM:
        return xlstm_lib.apply_slstm_block(bp, x, cfg, cache, mode)
    if bt == cfgbase.RGLRU:
        return rglru_lib.apply_rglru_block(bp, x, cfg, cache, mode)
    raise ValueError(bt)


def _store(dst: torch.Tensor, src: torch.Tensor) -> None:
    if dst.data_ptr() != src.data_ptr():
        dst.copy_(src)


def _rebuild(like, it):
    """A tree shaped as ``like`` whose leaves are taken from ``it`` in
    :func:`tree_leaves`' order (dict keys kept in ``like``'s order)."""
    if isinstance(like, dict):
        vals = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(t, it) for t in like)
    return next(it)


def _units(seg_params, count: int) -> list:
    """Each unit's slice of the stacked params: one ``unbind`` per leaf,
    whose backward stacks the units' gradients in one op (``a[u]`` per
    unit would add a zero tensor of the whole stack per unit)."""
    parts = [a.unbind(0) for a in tree_leaves(seg_params)]
    return [_rebuild(seg_params, iter([p[u] for p in parts]))
            for u in range(count)]


def _run_segment(seg_params, x, cfg, pattern, mode, positions,
                 seg_cache=None, pos=None, enc_out=None, causal=True):
    """Applies the unit to each of its stacked params in turn.  Returns
    (x, caches): prefill stacks the units' new caches; decode writes them
    into ``seg_cache`` in place and returns it.  In train mode with
    ``cfg.remat`` (the reference's ``jax.checkpoint`` of the unit body)
    each unit runs under ``torch.utils.checkpoint`` while autograd
    records: only its input is kept, its activations are recomputed in
    the backward."""
    count = tree_leaves(seg_params)[0].shape[0]
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    built = []
    for u, up in enumerate(_units(seg_params, count)):
        uc = tree_map(lambda a: a[u], seg_cache) if mode == "decode" else None

        def body(x, up=up, uc=uc):
            new_uc = {}
            for i, bt in enumerate(pattern):
                bc = uc[f"b{i}"] if uc is not None else None
                x, nc = _apply_block(up[f"b{i}"], x, cfg, bt, positions,
                                     mode, bc, pos, enc_out, causal=causal)
                new_uc[f"b{i}"] = nc
            return x, new_uc

        if remat:
            x = checkpoint(lambda x, body=body: body(x)[0], x,
                           use_reentrant=False)
            continue
        x, new_uc = body(x)
        if mode == "decode":
            tree_map(_store, uc, new_uc)
        elif mode == "prefill":
            built.append(new_uc)
    if mode == "decode":
        return x, seg_cache
    if mode == "prefill":
        return x, tree_map(lambda *a: torch.stack(a), *built)
    return x, None


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------
def encode(params, cfg, frame_embeds, mode="encode"):
    """Audio encoder: frame_embeds [B,F,d] -> [B,F,d]."""
    B, F, _ = frame_embeds.shape
    positions = torch.arange(F, dtype=torch.int32,
                             device=frame_embeds.device).expand(B, F)
    x, _ = _run_segment(params["encoder"]["stack"], frame_embeds, cfg,
                        (cfgbase.ATTN,), "train", positions, causal=False)
    return rms_norm(x, params["encoder"]["final_ln"], cfg.norm_eps)


def embed_inputs(params, cfg, tokens, extra):
    """Token embedding + modality stubs. Returns (x, positions)."""
    dt = dtype_of(cfg.dtype)
    x = mul_weak(params["embed"][tokens].to(dt), cfg.d_model ** 0.5)
    B, T = tokens.shape
    if cfg.num_patch_tokens and extra is not None and "patch_embeds" in extra:
        patches = extra["patch_embeds"].to(dt)              # [B,P,d]
        x = torch.cat([patches, x], dim=1)
        T = x.shape[1]
    if cfg.mrope_sections is not None:
        if extra is not None and "positions" in extra:
            positions = extra["positions"]                  # [B,3,T]
        else:
            positions = torch.arange(T, dtype=torch.int32,
                                     device=x.device).expand(B, 3, T)
    else:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=x.device).expand(B, T)
    return x, positions


def forward(params, cfg, tokens, extra=None, mode="train"):
    """Full-sequence forward.

    Returns hidden [B,T',d] for train; (hidden, cache) for prefill.
    T' includes prepended patch tokens for VLM.
    """
    params = as_params(params)
    x, positions = embed_inputs(params, cfg, tokens, extra)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encode(params, cfg, extra["frame_embeds"])
    caches = []
    for si, (pattern, count) in enumerate(segments_spec(cfg)):
        x, c = _run_segment(params[f"seg{si}"], x, cfg, pattern, mode,
                            positions, pos=None, enc_out=enc_out)
        caches.append(c)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    if mode == "prefill":
        return x, caches
    return x


def logits_from_hidden(params, cfg, h):
    """float32 logits [B,T,V]: the products of ``h`` and the (un)embedding
    in ``h``'s dtype, summed in float32 (the reference's
    ``preferred_element_type``), ``LOGIT_CHUNK`` vocab columns at a time."""
    params = as_params(params)
    dt = h.dtype
    hf = h.float()
    if cfg.tie_embeddings:
        w, cols = params["embed"], lambda a, b: params["embed"][a:b].t()
    else:
        w, cols = params["unembed"], lambda a, b: params["unembed"][:, a:b]
    V = w.shape[0] if cfg.tie_embeddings else w.shape[1]
    return torch.cat([hf @ cols(a, min(a + LOGIT_CHUNK, V)).to(dt).float()
                      for a in range(0, V, LOGIT_CHUNK)], dim=-1)


def decode_step(params, cfg, caches, token, pos, extra=None):
    """token: [B,1]; pos: a scalar (every row at one position) or a [B]
    tensor (each row its own sequence, as the scheduler's slots, whose MoE
    FFN then routes each row alone).  Returns (logits [B,1,V], caches);
    the caches are updated in place."""
    params = as_params(params)
    dt = dtype_of(cfg.dtype)
    x = mul_weak(params["embed"][token].to(dt), cfg.d_model ** 0.5)
    B = token.shape[0]
    if not torch.is_tensor(pos):          # a fill on the device, no copy
        pos = torch.full((), int(pos), dtype=torch.long, device=x.device)
    p = row_positions(pos, B, x.device).to(torch.int32)
    if cfg.mrope_sections is not None:
        positions = p[:, None, None].expand(B, 3, 1)
    else:
        positions = p[:, None]
    for si, (pattern, count) in enumerate(segments_spec(cfg)):
        x, _ = _run_segment(params[f"seg{si}"], x, cfg, pattern, "decode",
                            positions, seg_cache=caches[si], pos=pos)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return logits_from_hidden(params, cfg, x), caches


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def _init_block_cache(cfg, bt, batch, cache_len, dtype, cross_len, device):
    if bt in cfgbase.ATTENTION_BLOCKS:
        return blk.init_attn_cache(cfg, batch, cache_len, bt, dtype,
                                   cross_len, device)
    if bt == cfgbase.MLSTM:
        return xlstm_lib.init_mlstm_cache(cfg, batch, dtype, device)
    if bt == cfgbase.SLSTM:
        return xlstm_lib.init_slstm_cache(cfg, batch, dtype, device)
    if bt == cfgbase.RGLRU:
        return rglru_lib.init_rglru_cache(cfg, batch, dtype, device)
    raise ValueError(bt)


def init_cache(cfg, batch, cache_len, dtype=None, device=None):
    """Caches matching forward()'s segment structure, stacked over units."""
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.dtype)
    cross_len = (cfg.num_frame_tokens if cfg.is_encoder_decoder else 0)
    caches = []
    for pattern, count in segments_spec(cfg):
        unit = {f"b{i}": _init_block_cache(cfg, bt, batch, cache_len, dtype,
                                           cross_len, device)
                for i, bt in enumerate(pattern)}
        caches.append(tree_map(
            lambda a: a[None].repeat((count,) + (1,) * a.dim()), unit))
    return caches
