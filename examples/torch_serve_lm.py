"""Serve a (reduced) assigned architecture with batched greedy decoding on
the PyTorch/CUDA port: prefill a prompt batch, then decode tokens against
the KV/state cache (counterpart of ``examples/serve_lm.py``).

  PYTHONPATH=src python examples/torch_serve_lm.py --arch mixtral-8x7b --tokens 16
Every one of the 10 assigned architectures works (--arch <id>); the card
by default, ``--device cpu`` on the host.  The weights, the prompt and the
frame embeddings are the reference example's draws, bit for bit
(``init_params``, ``threefry.randint``, ``normal``), so both print the
same ids.
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.device import resolve_device
from repro_torch.models.normal import normal
from repro_torch.models.transformer import model as M
from repro_torch.pipeline import threefry
from repro_torch.train import lm_trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    print(f"serving {args.arch} (reduced: {cfg.num_layers}L "
          f"d={cfg.d_model} V={cfg.vocab_size})")
    params = M.init_params(0, cfg, device)

    B, T = args.batch, args.prompt_len
    tokens = threefry.randint(threefry.key(1), (B, T), 0, cfg.vocab_size,
                              device=device).long()
    batch = {"tokens": tokens}
    if cfg.num_patch_tokens:
        batch["patch_embeds"] = torch.zeros(
            (B, cfg.num_patch_tokens, cfg.d_model), device=device)
    if cfg.is_encoder_decoder:
        batch["frame_embeds"] = torch.from_numpy(normal(
            threefry.key(2), (B, cfg.num_frame_tokens, cfg.d_model))).to(device)

    prefill = lm_trainer.make_prefill_step(cfg)
    serve = lm_trainer.make_serve_step(cfg)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.time()
    logits, caches = prefill(params, batch)
    # grow caches: re-init at full length and replay the prompt (the
    # reference example's simple path; the prefill caches are dropped)
    cache = M.init_cache(cfg, B, T + args.tokens, device=device)
    for t in range(T):
        _, _, cache = serve(params, cache, tokens[:, t:t + 1], t)
    sync()
    print(f"prefill({T} tokens): {time.time()-t0:.2f}s")

    token = torch.argmax(logits[:, -1, :], -1)[:, None].to(torch.int32)
    out = [token]
    t0 = time.time()
    for i in range(args.tokens - 1):
        token, logits, cache = serve(params, cache, token.long(), T + i)
        out.append(token)
    sync()
    dt = time.time() - t0
    gen = torch.cat(out, dim=1)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the CPU")
    print(f"decoded {args.tokens} tokens/seq x {B} seqs in {dt:.2f}s "
          f"({args.tokens*B/max(dt,1e-9):.1f} tok/s on {where})")
    print("generated ids:", gen.tolist())


if __name__ == "__main__":
    main()
