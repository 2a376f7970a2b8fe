"""Serving example, on the PyTorch port: batched requests through the paged
KV-cache with Scavenger+-style page GC (run-coalesced compaction,
pressure-driven scheduling), using a real reduced model end to end.  The
requests, the schedule and the line printed are those of
examples/serve_paged.py; ``compaction_dmas`` counts coalesced copies, as
the JAX package's kernel path does (its default plain path counts live
pages).  On the card, decode attention is the paged-attention kernel and
compaction the page-gather kernel.

Run:  PYTHONPATH=src python examples/torch_serve_paged.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.serving import (PagedCacheConfig, PagedKVCache, Request,
                                 ServeConfig, ServeLoop)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = resolve_device(ap.parse_args().device)

cfg = get_config("phi3-mini-3.8b", smoke=True)
model = get_model(cfg)
params = model.init(cfg, torch.Generator(device).manual_seed(0), device)

cache = PagedKVCache(cfg, PagedCacheConfig(n_pages=256, page_size=4,
                                           device=str(device)))
loop = ServeLoop(cfg, cache, ServeConfig(max_batch=4, frag_threshold=0.2))

rng = np.random.default_rng(0)
for i in range(16):
    loop.submit(Request(rid=i, prompt_len=int(rng.integers(4, 24)),
                        max_new_tokens=int(rng.integers(4, 12))))

# A toy decode_fn: runs the model's first attention layer against the
# paged pool (full multi-layer serving wires every layer the same way).
wk = {k: w[0] for k, w in params["layers"]["attn"].items()}
gen = torch.Generator(device)


def decode_fn(seq_ids):
    # seeded by the batch size, as the JAX example seeds jax.random
    gen.manual_seed(len(seq_ids))
    x = torch.randn((len(seq_ids), 1, cfg.d_model), generator=gen,
                    device=device, dtype=torch.float32)
    k = torch.einsum("bsd,dhk->bshk", x, wk["wk"])[:, 0]
    v = torch.einsum("bsd,dhk->bshk", x, wk["wv"])[:, 0]
    for i, s in enumerate(seq_ids):
        cache.write_token_kv(0, s, k[i], v[i])
    q = torch.einsum("bsd,dhk->bshk", x, wk["wq"])[:, 0]
    out = cache.attend(0, seq_ids, q)
    assert bool(torch.isfinite(out).all())


loop.run(decode_fn, max_steps=2000)
print(f"completed={len(loop.done)} decode_steps={loop.decode_steps} "
      f"compactions={loop.compaction_steps} "
      f"compaction_dmas={cache.compaction_dmas} "
      f"fragmentation={cache.fragmentation():.3f}")
assert len(loop.done) == 16
