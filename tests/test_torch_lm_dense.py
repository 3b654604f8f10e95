"""The port's LM serving path (``repro_torch.models.transformer``,
``train/lm_trainer.py``) against the reference's, for the six attention-
only architectures at their ``reduced()`` widths: prefill logits and
every cache leaf, decode continuing from the prefill caches (the
enc-dec's cross-attention reads its encoder's keys there), the prompt
replayed through an empty cache (and, where prefill sees only tokens,
prefill == replay), and greedy decode from an empty cache; M-RoPE with
patch embeddings and distinct t/h/w position streams (qwen2-vl), frame
embeddings through the encoder (seamless); the sliding window's ring
cache at a prompt past the reduced window (h2o-danube).

The reference's weights are carried in by name; tolerances in
``_lm_parity.py`` (1e-4 * max(1, |x|) on float32, ints and ids exact).
"""
import pytest

from _lm_parity import RING_T, check_run, run

ARCHS = ("command-r-plus-104b", "h2o-danube-3-4b", "minitron-4b",
         "minitron-8b", "qwen2-vl-7b", "seamless-m4t-medium")


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_path_matches_reference(arch):
    check_run(arch)


def test_ring_cache_past_the_window():
    """An 80-token prompt through 64-slot ring caches: from_prefill keeps
    the trailing window rolled to slot p % 64, decode writes over the
    oldest, and the prompt replayed through a ring that wraps gives the
    prefill's logits."""
    arch = "h2o-danube-3-4b"
    check_run(arch, batch_size=1, length=RING_T, after=4, steps=0)
    ref, port = run(arch, batch_size=1, length=RING_T, after=4, steps=0)
    kv = port["prefill_cache"][0]["b0"]["kv"]
    assert kv.ring and kv.pos.shape[-1] == 64
    assert sorted(kv.pos[0, 0].tolist()) == list(range(RING_T - 64, RING_T))
    assert all(p % 64 == s for s, p in enumerate(kv.pos[0, 0].tolist()))
