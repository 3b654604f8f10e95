"""Batched serving with the continuous-batching scheduler on the
PyTorch/CUDA port: more requests than device slots; slots are reused as
requests finish (counterpart of ``examples/batch_serve.py``).

  PYTHONPATH=src python examples/torch_batch_serve.py --arch qwen2-vl-7b
The card by default, ``--device cpu`` on the host; the reference
example's weights (``init_params(0, ...)``, bit for bit) and prompts.
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.device import resolve_device
from repro_torch.models.transformer import model as M
from repro_torch.serve.scheduler import Request, serve_requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--tokens", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    params = M.init_params(0, cfg, device)
    reqs = [Request(rid=i, prompt=[1 + i, 2 + i, 3 + i],
                    max_tokens=args.tokens) for i in range(args.requests)]
    t0 = time.time()
    reqs, steps = serve_requests(cfg, params, reqs, num_slots=args.slots,
                                 cache_len=64, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    for r in reqs:
        print(f"req {r.rid}: {r.generated}")
    total = sum(len(r.generated) for r in reqs)
    print(f"{args.requests} requests through {args.slots} slots: "
          f"{steps} batched decode steps, {total} tokens in {dt:.1f}s")


if __name__ == "__main__":
    main()
