"""Serving driver: continuous batching over the paged KV cache with
Scavenger+-style page GC, end to end.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --full [--requests 24] [--pages 256] [--frag-threshold 0.2] \
      [--device cuda]

The driver reports the scheduling split between decode and compaction
iterations and the run-coalescing copy statistics — the serving-tier
analog of the paper's Fig. 19/20 resource-efficiency story.  ``--full``
takes the architecture's full config in place of its reduced SMOKE one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import get_model
from ..serving import (PagedCacheConfig, PagedKVCache, Request, ServeConfig,
                       ServeLoop)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--pages", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--frag-threshold", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="full-width config instead of the SMOKE one")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    model = get_model(cfg)
    if "layers" not in model.specs(cfg):
        # as the JAX driver, which fails on params["layers"]
        ap.error(f"--arch {args.arch}: the driver attends through layer 0 "
                 "of a stacked-layer model, and this one has none")
    gen = torch.Generator(device).manual_seed(args.seed)
    params = model.init(cfg, gen, device)
    cache = PagedKVCache(cfg, PagedCacheConfig(
        n_pages=args.pages, page_size=args.page_size, device=str(device)))
    loop = ServeLoop(cfg, cache, ServeConfig(
        max_batch=args.max_batch, frag_threshold=args.frag_threshold))

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        loop.submit(Request(rid=i, prompt_len=int(rng.integers(4, 32)),
                            max_new_tokens=int(rng.integers(4, 16))))

    # Layer-0 attention drives the paged pool, as in the JAX driver.
    lp0 = {k: w[0] for k, w in params["layers"]["attn"].items()}

    def decode_fn(seq_ids):
        # x is seeded by (seed, decode step), as the JAX driver seeds it by
        # the decode step; the draws differ from jax.random's.
        seed = np.random.SeedSequence([args.seed, loop.decode_steps])
        gen.manual_seed(int(seed.generate_state(1, np.uint64)[0] >> 1))
        x = torch.randn((len(seq_ids), 1, cfg.d_model), generator=gen,
                        device=device, dtype=torch.float32)
        k = torch.einsum("bsd,dhk->bshk", x, lp0["wk"])[:, 0]
        v = torch.einsum("bsd,dhk->bshk", x, lp0["wv"])[:, 0]
        for i, s in enumerate(seq_ids):
            cache.write_token_kv(0, s, k[i], v[i])
        q = torch.einsum("bsd,dhk->bshk", x, lp0["wq"])[:, 0]
        out = cache.attend(0, seq_ids, q)
        if not bool(torch.isfinite(out).all()):
            raise FloatingPointError(
                f"non-finite attention output at decode step "
                f"{loop.decode_steps}")

    t0 = time.perf_counter()
    loop.run(decode_fn, max_steps=5000)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    p = loop.pressures()
    print(f"completed={len(loop.done)}/{args.requests} "
          f"decode_steps={loop.decode_steps} "
          f"compaction_steps={loop.compaction_steps} "
          f"compaction_dmas={cache.compaction_dmas} "
          f"alloc_failures={cache.alloc_failures} "
          f"frag={cache.fragmentation():.3f} "
          f"pressures=(admit={p['admit']:.2f},frag={p['frag']:.2f}) "
          f"wall={wall:.1f}s", flush=True)
    return 0 if len(loop.done) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
