"""The port's LM serving path in bfloat16 against the reference's own
bfloat16 run on the same weights, for a dense (minitron-4b), a sliding
window (h2o-danube-3-4b) and an MoE (mixtral-8x7b, also windowed)
architecture at their ``reduced()`` widths, an 80-token prompt past the
reduced window: params float32 and cast at each use, every product in
bf16 but the scores, the router logits and the final logits (float32).

The reference runs once in a subprocess with XLA rounding every op to
the dtype its code gives it (``_lm_bf16.EXACT_FLAGS``).  Tolerances
(``_lm_bf16.py``; D is the reference's own bf16-vs-float32 rms distance
on the same inputs):

* the whole model (prefill logits, 4 decode steps, every cache leaf):
  rms within ``RMS_TOL`` = 0.6 of D, above the reference's own spread
  (its logits moved by 1e-7 embedding noise, checked here to lie under
  the tolerance), cache positions exactly;
* the first block on the reference's own bf16 input (prefill, then a
  decode step from the reference's prefill cache): at least
  ``BLOCK_EQUAL`` = 99% of its bf16 outputs and cache entries bit for bit
  (a sum in another order may round the other way), positions exactly;
  the float32 logits of the reference's bf16 hidden state within 1e-4 *
  max(1, |x|).

``python tests/_lm_bf16.py controls`` prints the port with scores,
logits or silu rounded where the reference does not: each fails one of
these bounds.
"""
import numpy as np
import pytest

from _lm_bf16 import (ARCHS, BLOCK_EQUAL, DRAWS, RMS_TOL, equal_share,
                      leaves, port_block, port_whole, reference, rms)
from _lm_parity import assert_close


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serving_matches_reference(arch):
    ref = reference()
    want, f32 = ref[f"{arch}/bf16"], ref[f"{arch}/f32"]
    D = rms(want, f32)
    spread = max(rms(ref[f"{arch}/noise/{k}"], want) for k in range(DRAWS))
    assert spread <= RMS_TOL * D < D, (spread / D, arch)
    got, cache = port_whole(arch)
    assert rms(got, want) <= RMS_TOL * D, (
        f"{arch}: logits {rms(got, want) / D:.3f} of D")
    ref_cache = leaves(ref, f"{arch}/bf16/cache")
    ref_f32 = leaves(ref, f"{arch}/f32/cache")
    assert len(cache) == len(ref_cache)
    for i, (g, w, w32) in enumerate(zip(cache, ref_cache, ref_f32)):
        assert g.shape == w.shape, (arch, i)
        if np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w), f"{arch}: cache leaf {i}"
        else:
            assert rms(g, w) <= RMS_TOL * rms(w, w32), (
                f"{arch}: cache leaf {i} {rms(g, w) / rms(w, w32):.3f} of D")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_block_matches_reference(arch):
    ref = reference()
    got = port_block(arch, ref)
    for what in ("y", "yd"):
        share = equal_share(got[what], ref[f"{arch}/block/{what}"])
        assert share >= BLOCK_EQUAL, f"{arch} {what}: {share:.4f} equal"
    for what in ("cache", "cache_d"):
        for i, (g, w) in enumerate(zip(got[what],
                                       leaves(ref, f"{arch}/block/{what}"))):
            if np.issubdtype(w.dtype, np.integer):
                assert np.array_equal(g, w), f"{arch} {what} {i}"
            else:
                share = equal_share(g, w)
                assert share >= BLOCK_EQUAL, f"{arch} {what} {i}: {share:.4f}"
    assert_close(got["logits"], ref[f"{arch}/block/logits"],
                 f"{arch} float32 logits of a bf16 hidden state")
