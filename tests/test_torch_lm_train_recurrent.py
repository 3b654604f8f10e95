"""The port's LM train step against the reference's for the recurrent
architectures at their ``reduced()`` widths (one step from the
reference's weights on ``tests/test_arch_smoke.py``'s batch, then a
second from the reference's state, as in
``test_torch_lm_train_dense.py``): xLSTM's mLSTM and sLSTM blocks, whose
exponential gates amplify float32 rounding, held to 4x the reference's
own spread of each quantity under 1e-7 relative embedding noise where
that is past 1e-4 (as its serving parity); recurrentgemma's RG-LRU and
local attention to 1e-4.
"""
import _lm_train_parity as P
from _lm_train_parity import one_torch_thread  # noqa: F401


def test_xlstm_train_step_within_reference_spread():
    P.check("xlstm-1.3b", spread=True)


def test_recurrentgemma_train_step_matches_reference():
    P.check("recurrentgemma-9b")
