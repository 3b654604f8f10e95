"""bfloat16 parity of the port's LM serving path with the reference's:
shared by ``tests/test_torch_lm_bf16.py``, and a script for the numbers
the tolerances rest on.

    PYTHONPATH=src:tests python tests/_lm_bf16.py controls
    PYTHONPATH=src:tests python tests/_lm_bf16.py depth

What the reference computes in bf16 is fixed by its code only where XLA
rounds every op to the dtype the code gives it.  By default XLA may keep
float32 between elementwise ops (``xla_allow_excess_precision``), so the
reference runs in a subprocess with ``EXACT_FLAGS`` ("every op
rounded"); ``controls`` also prints how far the reference compiled with
XLA's defaults lands from itself.

Distances are root mean squares over the compared logits (or cache
leaf), as a fraction of the reference's own bf16-vs-float32 distance on
the same weights and inputs (``D``).  bf16 rounding is chaotic: one
rounding that falls the other way (a sum taken in another order) moves
the downstream roundings, and the reference's own logits then move 0.2-0.5
of D (``spread``: its embedding perturbed by 1e-7, float32 rounding's
size).  So a whole model is held to ``RMS_TOL`` of D, above that spread;
each block on the reference's own bf16 input is held much tighter
(``BLOCK_EQUAL`` of its bf16 outputs bit for bit), which a port that
rounds at other points than the reference fails by far.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
import tempfile

import numpy as np

ARCHS = ("minitron-4b", "h2o-danube-3-4b", "mixtral-8x7b")  # dense, SWA, MoE
B, T, STEPS = 2, 80, 4       # a prompt past the reduced window (64)
NOISE, DRAWS = 1e-7, 2       # the spread's embedding noise
RMS_TOL = 0.6                # whole model: rms, as a fraction of D
BLOCK_EQUAL = 0.99           # a block's bf16 outputs equal bit for bit
EXACT_FLAGS = "--xla_allow_excess_precision=false"


def rms(got, want) -> float:
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return float(np.sqrt(np.mean(d * d)))


def tokens(cfg, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T + STEPS)).astype(np.int32)


def _f32(tree):
    """Leaves as float32 numpy (bf16 widens exactly; npz holds no bf16)."""
    import jax
    return [a.astype(np.float32) if str(a.dtype) == "bfloat16" else a
            for a in map(np.asarray, jax.tree_util.tree_leaves(tree))]


@functools.lru_cache(maxsize=None)
def _reference_steps(cfg):
    import jax
    from repro.train import lm_trainer as RL
    return (jax.jit(RL.make_prefill_step(cfg)),
            jax.jit(RL.make_serve_step(cfg)))


def _reference_whole(p, cfg, toks):
    """Prefill of the first T tokens, then STEPS decode steps fed the
    next tokens: the logits [B, 1 + STEPS, V] and the final caches."""
    import jax.numpy as jnp
    prefill, serve = _reference_steps(cfg)
    lg, c = prefill(p, {"tokens": jnp.asarray(toks[:, :T])})
    out = [np.asarray(lg, np.float32)]
    for i in range(STEPS):
        _, lg, c = serve(p, c, jnp.asarray(toks[:, T + i:T + i + 1]),
                         jnp.int32(T + i))
        out.append(np.asarray(lg, np.float32))
    return np.concatenate(out, 1), _f32(c)


def _reference_block(p, cfg, toks):
    """The first block on the reference's own bf16 embedding of the
    prompt (prefill), then one decode step from its cache: inputs,
    outputs and caches, and the f32 logits of the block's last row."""
    import jax
    import jax.numpy as jnp
    from repro.models.transformer import blocks as RB
    from repro.models.transformer import model as RM
    bp = jax.tree_util.tree_map(lambda a: a[0], p["seg0"]["b0"])
    bt = cfg.pattern[0]
    embed = jax.jit(lambda t: RM.embed_inputs(p, cfg, t, None))
    prefill = jax.jit(lambda x, positions: RB.apply_attn_block(
        bp, x, cfg, bt, positions, "prefill"))
    decode = jax.jit(lambda x, c, pos: RB.apply_attn_block(
        bp, x, cfg, bt, jnp.full((B, 1), pos, jnp.int32), "decode", cache=c,
        pos=pos))
    x, positions = embed(jnp.asarray(toks[:, :T]))
    y, c = prefill(x, positions)
    xd, _ = embed(jnp.asarray(toks[:, T:T + 1]))
    yd, cd = decode(xd, c, jnp.int32(T))
    logits = jax.jit(lambda h: RM.logits_from_hidden(p, cfg, h))(y[:, -1:])
    return {"x": _f32(x)[0], "y": _f32(y)[0], "cache": _f32(c["kv"]),
            "xd": _f32(xd)[0], "yd": _f32(yd)[0], "cache_d": _f32(cd["kv"]),
            "logits": np.asarray(logits, np.float32)}


def reference_outputs(archs=ARCHS) -> dict:
    """Every reference output the tests compare, flat (``arch/what``);
    run under ``EXACT_FLAGS``."""
    import jax
    from repro.configs import get_arch as ref_arch
    from repro.models.transformer import model as RM
    out = {}
    for arch in archs:
        r32 = ref_arch(arch).reduced()
        rbf = dataclasses.replace(r32, dtype="bfloat16")
        p = RM.init_params(jax.random.key(0), r32)
        toks = tokens(r32)
        for name, cfg in (("f32", r32), ("bf16", rbf)):
            lg, cache = _reference_whole(p, cfg, toks)
            out[f"{arch}/{name}"] = lg
            for i, leaf in enumerate(cache):
                out[f"{arch}/{name}/cache/{i}"] = leaf
        rng = np.random.default_rng(0)
        e = np.asarray(p["embed"])
        for k in range(DRAWS):
            q = dict(p, embed=jax.numpy.asarray((e * (1 + NOISE * rng.standard_normal(
                e.shape))).astype(np.float32)))
            out[f"{arch}/noise/{k}"] = _reference_whole(q, rbf, toks)[0]
        for key, v in _reference_block(p, rbf, toks).items():
            if isinstance(v, list):
                for i, leaf in enumerate(v):
                    out[f"{arch}/block/{key}/{i}"] = leaf
            else:
                out[f"{arch}/block/{key}"] = v
    return out


def _subprocess_env(exact=True):
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(here, "..", "src"), here] +
        ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    if exact:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " + EXACT_FLAGS).strip()
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


@functools.lru_cache(maxsize=None)
def reference(exact=True) -> dict:
    """:func:`reference_outputs` from a fresh process (XLA reads its
    flags once), every op rounded unless ``exact`` is False."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ref.npz")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "reference", path],
            env=_subprocess_env(exact), capture_output=True, text=True,
            timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def leaves(ref, prefix):
    n = sum(1 for k in ref if k.startswith(prefix + "/"))
    return [ref[f"{prefix}/{i}"] for i in range(n)]


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------
def port_params(arch):
    """The reference's float32 weights (key 0) in the port's tree."""
    from _lm_parity import setup
    return setup(arch)[3]


def port_whole(arch):
    """:func:`_reference_whole` of the port in bf16."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as M
    from repro_torch.train import lm_trainer as L
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="bfloat16")
    tp = port_params(arch)
    toks = torch.as_tensor(tokens(cfg)).long()
    serve = L.make_serve_step(cfg)
    lg, c = L.make_prefill_step(cfg)(tp, {"tokens": toks[:, :T]})
    out = [lg.float()]
    for i in range(STEPS):
        _, lg, c = serve(tp, c, toks[:, T + i:T + i + 1], T + i)
        out.append(lg.float())
    return torch.cat(out, 1).numpy(), [
        a.float().numpy() if a.is_floating_point() else a.numpy()
        for a in M.tree_leaves(c)]


def port_block(arch, ref):
    """:func:`_reference_block` of the port, on the reference's inputs
    (its bf16 embedding, its prefill cache for the decode step)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import blocks as TB
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer.attention import KVCache
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="bfloat16")
    tp = port_params(arch)
    bp = M.tree_map(lambda a: a[0], tp["seg0"]["b0"])
    bt = cfg.pattern[0]
    bf = lambda a: torch.as_tensor(a).bfloat16()  # noqa: E731
    x = bf(ref[f"{arch}/block/x"])
    positions = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    y, c = TB.apply_attn_block(bp, x, cfg, bt, positions, "prefill")
    k, v, pos = leaves(ref, f"{arch}/block/cache")
    kv = KVCache(bf(k), bf(v), torch.tensor(pos), ring=c["kv"].ring)
    yd, cd = TB.apply_attn_block(
        bp, bf(ref[f"{arch}/block/xd"]), cfg, bt,
        torch.full((B, 1), T, dtype=torch.int32), "decode",
        cache={"kv": kv}, pos=T)
    logits = M.logits_from_hidden(tp, cfg, bf(ref[f"{arch}/block/y"])[:, -1:])
    f = lambda t: t.float().numpy() if t.is_floating_point() else t.numpy()  # noqa: E731
    return {"y": f(y), "cache": [f(c["kv"].k), f(c["kv"].v), f(c["kv"].pos)],
            "yd": f(yd), "cache_d": [f(cd["kv"].k), f(cd["kv"].v),
                                     f(cd["kv"].pos)],
            "logits": f(logits)}


def equal_share(got, want) -> float:
    return float(np.mean(np.asarray(got) == np.asarray(want)))


# ---------------------------------------------------------------------------
# the script
# ---------------------------------------------------------------------------
def _controls():
    """The port (and three faults patched into it) against the
    reference, whole model and first block, as a fraction of D."""
    import contextlib

    import torch

    from _lm_parity import rel_err
    from repro_torch.models.transformer import blocks as TB
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer import moe as TMoE
    ref, loose = reference(True), reference(False)
    einsum, logits = torch.einsum, M.logits_from_hidden

    def scores_bf16(eq, *ops):
        out = einsum(eq, *ops)
        return out.bfloat16().float() if eq == "btkgd,bskd->btkgs" else out

    faults = {
        "the port": {},
        "scores rounded to bf16": {(torch, "einsum"): scores_bf16},
        "logits rounded to bf16": {(M, "logits_from_hidden"): lambda p, c, h:
                                   logits(p, c, h).bfloat16().float()},
        "silu rounded once": {(TB, "silu"): torch.nn.functional.silu,
                              (TMoE, "silu"): torch.nn.functional.silu},
    }

    @contextlib.contextmanager
    def patched(fixes):
        saved = {k: getattr(*k) for k in fixes}
        for (mod, name), f in fixes.items():
            setattr(mod, name, f)
        try:
            yield
        finally:
            for (mod, name), f in saved.items():
                setattr(mod, name, f)
    with torch.no_grad():
        for arch in ARCHS:
            want, f32 = ref[f"{arch}/bf16"], ref[f"{arch}/f32"]
            D = rms(want, f32)
            spread = max(rms(ref[f"{arch}/noise/{k}"], want) / D
                         for k in range(DRAWS))
            print(f"{arch}: D {D:.4e}; the reference's spread {spread:.3f} "
                  f"of D, compiled with XLA's default flags "
                  f"{rms(loose[f'{arch}/bf16'], want) / D:.3f}")
            for name, fixes in faults.items():
                with patched(fixes):
                    got = port_whole(arch)[0]
                    blk = port_block(arch, ref)
                print(f"  {name}: whole model {rms(got, want) / D:.3f} of D, "
                      f"max |d| {np.abs(got - want).max():.3e}; first block "
                      f"prefill {equal_share(blk['y'], ref[f'{arch}/block/y']):.4f} "
                      f"and decode {equal_share(blk['yd'], ref[f'{arch}/block/yd']):.4f}"
                      f" of its bf16 outputs equal, float32 logits "
                      f"{rel_err(blk['logits'], ref[f'{arch}/block/logits']):.1e}"
                      f" relative")


def _depth(archs=(("minitron-4b", 4), ("h2o-danube-3-4b", 1)), length=512):
    """The reference's own prefill against the prompt replayed through
    decode, in bf16 at the published depth (reduced widths), beside the
    port's: max |prefill - replay| and each one's max |x - float32 run|
    of the last position's logits."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_arch as ref_arch
    from repro.models.transformer import model as RM
    from repro.train import lm_trainer as RL
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as M
    from repro_torch.train import lm_trainer as L
    def deep(get, arch, dtype):
        full = get(arch)
        return dataclasses.replace(full.reduced(), num_units=full.num_units,
                                   num_layers=full.num_layers, dtype=dtype)

    for arch, batch in archs:
        cfg = deep(ref_arch, arch, "float32")
        p = RM.init_params(jax.random.key(0), cfg)
        tp = M.params_from_reference(jax.tree_util.tree_map(np.asarray, p),
                                     device="cpu")
        toks = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (batch, length)).astype(np.int32)
        line = []
        for name in ("reference", "port"):
            if name == "reference":
                prefill = {dt: jax.jit(RL.make_prefill_step(
                    deep(ref_arch, arch, dt))) for dt in ("float32", "bfloat16")}
                got = {dt: np.asarray(f(p, {"tokens": jnp.asarray(toks)})[0],
                                      np.float32) for dt, f in prefill.items()}
                c = deep(ref_arch, arch, "bfloat16")
                serve = jax.jit(RL.make_serve_step(c))
                cache = RM.init_cache(c, batch, length)
                for t in range(length):
                    _, lg, cache = serve(p, cache, jnp.asarray(toks[:, t:t + 1]),
                                         jnp.int32(t))
                replay = np.asarray(lg, np.float32)
            else:
                tt = torch.as_tensor(toks).long()
                with torch.no_grad():
                    got = {dt: L.make_prefill_step(deep(get_arch, arch, dt))(
                        tp, {"tokens": tt})[0].float().numpy()
                        for dt in ("float32", "bfloat16")}
                    c = deep(get_arch, arch, "bfloat16")
                    serve = L.make_serve_step(c)
                    cache = M.init_cache(c, batch, length, device="cpu")
                    for t in range(length):
                        _, lg, cache = serve(tp, cache, tt[:, t:t + 1], t)
                replay = lg.float().numpy()
            pre, f32 = got["bfloat16"], got["float32"]
            line.append(
                f"{name}: max |prefill - replay| "
                f"{np.abs(pre - replay).max():.4e}, from float32 the prefill "
                f"{np.abs(pre - f32).max():.4e} and the replay "
                f"{np.abs(replay - f32).max():.4e} (|logits| up to "
                f"{np.abs(f32).max():.2f})")
        print(f"{arch}, {cfg.num_layers} layers at d {cfg.d_model}, bf16, "
              f"{batch} x {length} tokens; " + "; ".join(line), flush=True)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "reference":
        np.savez(sys.argv[2], **reference_outputs())
    elif mode == "controls":
        _controls()
    elif mode == "depth":
        if EXACT_FLAGS not in os.environ.get("XLA_FLAGS", ""):
            os.execve(sys.executable, [sys.executable] + sys.argv,
                      _subprocess_env(True))
        _depth()
    else:
        raise SystemExit(f"unknown mode {mode!r}")
