"""End-to-end LM training driver on the PyTorch/CUDA port (counterpart of
``examples/train_lm.py``): trains a 40M-param dense model (the
reference's ``make_100m``) for a few hundred steps on synthetic data and
shows the loss dropping toward the unigram floor.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 200

The card by default, ``--device cpu`` on the host.  The weights and the
token stream are the reference example's draws, bit for bit
(``init_params``; ``threefry``'s ``split``, ``randint``, ``fold_in`` and
jax's ``bernoulli``, ``uniform < p``), so both print the same losses up
to float32 rounding; the tokens/s line names the device.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import model as M
from repro_torch.pipeline import threefry
from repro_torch.train import lm_trainer
from repro_torch.train.optimizer import AdamConfig, adam_init
from repro_torch.utils.tree import tree_count_params


def make_100m() -> ArchConfig:
    return ArchConfig(
        name="dense-100m", arch_type="dense", source="examples/train_lm.py",
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
        d_ff=2048, vocab_size=8192, pattern=(ATTN,), dtype="float32",
        remat=False, q_chunk=256)


def synthetic_stream(key, batch, seq, vocab):
    """Markov-ish synthetic tokens (learnable bigram structure): the
    reference's draws, step t's noise and coin from ``fold_in(k2, t)`` and
    ``fold_in(k1, t)``, all steps drawn at once; the chain itself runs on
    the host.  Returns int64 [batch, seq] on the CPU."""
    k1, k2 = threefry.split(key)
    table = threefry.randint(k1, (vocab,), 0, vocab).numpy()
    toks = np.empty((batch, seq), np.int64)
    toks[:, 0] = threefry.randint(k2, (batch, 1), 0, vocab).numpy()[:, 0]
    t = torch.arange(1, seq, dtype=torch.int32)
    noise = threefry.randint_keys(threefry.fold_in_keys(k2, t), batch, 0,
                                  vocab).numpy()
    coin = (threefry.uniform_keys(threefry.fold_in_keys(k1, t), batch)
            < np.float32(0.8)).numpy()
    for i in range(1, seq):
        toks[:, i] = np.where(coin[i - 1], table[toks[:, i - 1]],
                              noise[i - 1])
    return torch.from_numpy(toks)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = make_100m()
    params = M.init_params(0, cfg, device)
    print(f"params: {tree_count_params(params)/1e6:.1f}M")
    opt = adam_init(M.tree_leaves(params))
    step = lm_trainer.make_train_step(cfg, AdamConfig(lr=3e-4,
                                                      grad_clip=1.0))
    key = threefry.key(1)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the CPU")
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        key, k = threefry.split(key)
        tokens = synthetic_stream(k, args.batch, args.seq,
                                  cfg.vocab_size).to(device)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            sync()
            tok_s = args.batch * args.seq * (i + 1) / (time.time() - t0)
            print(f"step {i:4d}: loss={losses[-1]:.4f} ({tok_s:.0f} tok/s "
                  f"on {where})")
    assert losses[-1] < losses[0], "loss must decrease"
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps")


if __name__ == "__main__":
    main()
