"""The port's paged KV cache and serve driver against the JAX package's,
on the CPU.  The JAX side runs its kernel path (Pallas in interpret mode),
which counts coalesced copies as the port always does."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import serve as j_serve
from repro.models import get_model as j_get_model
from repro.serving import PagedCacheConfig as JPagedCacheConfig
from repro.serving import PagedKVCache as JPagedKVCache
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeLoop as JServeLoop
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.serving import PagedCacheConfig, PagedKVCache


def _caches(n_pages=24, page_size=4):
    jc = JPagedKVCache(j_get_config("olmo-1b", smoke=True), JPagedCacheConfig(
        n_pages=n_pages, page_size=page_size, use_pallas=True,
        interpret=True))
    tc = PagedKVCache(get_config("olmo-1b", smoke=True), PagedCacheConfig(
        n_pages=n_pages, page_size=page_size, device="cpu"))
    return jc, tc


def _assert_same_state(jc, tc):
    assert tc.tables == jc.tables
    assert tc.lengths == jc.lengths
    assert tc.free == jc.free
    assert tc.frozen == jc.frozen
    assert (tc.compactions, tc.compaction_dmas, tc.alloc_failures) == \
        (jc.compactions, jc.compaction_dmas, jc.alloc_failures)
    assert tc.fragmentation() == jc.fragmentation()
    # both round f32 to bf16 to nearest even: the pools are bit-identical
    assert tc.pool.dtype == torch.bfloat16
    np.testing.assert_array_equal(tc.pool.float().numpy(),
                                  np.asarray(jc.pool.astype(jnp.float32)))


def test_scripted_cache_matches_jax_bit_for_bit():
    jc, tc = _caches()
    cfg = get_config("olmo-1b", smoke=True)
    rng = np.random.default_rng(5)

    def decode(seq_ids):
        ok = [s for s in seq_ids if jc.append_token(s)]
        assert [s for s in seq_ids if tc.append_token(s)] == ok
        for s in ok:
            for layer in range(cfg.n_layers):
                k, v = (rng.normal(size=(cfg.kv_heads, cfg.head_dim))
                        .astype(np.float32) for _ in range(2))
                jc.write_token_kv(layer, s, jnp.asarray(k), jnp.asarray(v))
                tc.write_token_kv(layer, s, torch.from_numpy(k),
                                  torch.from_numpy(v))
        _assert_same_state(jc, tc)
        attend(ok)

    def attend(seq_ids):
        q = rng.normal(size=(len(seq_ids), cfg.n_heads, cfg.head_dim)) \
            .astype(np.float32)
        for layer in range(cfg.n_layers):
            want = jc.attend(layer, seq_ids, jnp.asarray(q))
            got = tc.attend(layer, seq_ids, torch.from_numpy(q))
            # f32 q over a bf16 pool: both compute in f32 (2e-5)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-5, rtol=2e-5)

    def both(method, *args):
        assert getattr(tc, method)(*args) == getattr(jc, method)(*args)
        _assert_same_state(jc, tc)

    # prompts reserve pages that nothing writes: attend reads them anyway
    for sid, prompt in [(1, 5), (2, 9), (3, 3), (4, 0)]:
        both("add_sequence", sid, prompt)
    for _ in range(6):
        decode([1, 2, 3, 4])
    both("finish_sequence", 2)
    both("freeze", 3)
    both("compact")
    attend([1, 3, 4])
    both("add_sequence", 5, 13)
    both("add_sequence", 6, 30)      # no room: counted as a failure
    for _ in range(5):
        decode([1, 3, 4, 5])
    both("finish_sequence", 1)
    both("finish_sequence", 4)
    # stale slots past the live count now hold old pages the new
    # sequence's prompt will read
    both("compact")
    both("add_sequence", 7, 6)
    for _ in range(3):
        decode([3, 5, 7])
    both("finish_sequence", 5)
    both("compact")
    attend([3, 7])


def _count_line(text):
    return re.search(r"completed=\S+ decode_steps=\d+ compaction_steps=\d+ "
                     r"compaction_dmas=\d+ alloc_failures=\d+", text).group(0)


def test_driver_matches_jax_kernel_path(capsys):
    _check_driver_against_jax("olmo-1b", capsys)


def test_moe_driver_matches_jax_kernel_path(capsys):
    """granite-moe-3b-a800m: the driver attends through layer 0's
    attention (24 heads over 8 at full width, 6 over 2 at SMOKE); the
    traffic, so every count, is olmo's."""
    _check_driver_against_jax("granite-moe-3b-a800m", capsys)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "hubert-xlarge"])
def test_vlm_and_audio_drivers_match_jax_kernel_path(arch, capsys):
    """qwen2-vl-2b (12 heads over 2 at full width, 4 over 2 at SMOKE) and
    hubert-xlarge (16 over 16, D 80; 4 over 4 at SMOKE): the driver
    attends through layer 0's attention projections, with no RoPE and no
    frontend on that path in either package; the counts are olmo's."""
    _check_driver_against_jax(arch, capsys)


def test_hybrid_is_refused_by_both_drivers():
    """jamba-v0.1-52b keeps its layers under ``blocks``: the JAX driver
    fails on ``params["layers"]``, the port's refuses the arch up front
    (exit 2), before it draws any weight."""
    with pytest.raises(KeyError, match="layers"):
        j_serve.main(["--arch", "jamba-v0.1-52b"])
    with pytest.raises(SystemExit) as refused:
        serve.main(["--arch", "jamba-v0.1-52b", "--device", "cpu"])
    assert refused.value.code == 2


def _check_driver_against_jax(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu"]) == 0
    line = _count_line(capsys.readouterr().out)
    assert line == ("completed=24/24 decode_steps=62 compaction_steps=12 "
                    "compaction_dmas=360 alloc_failures=0")

    # The JAX driver on the same request stream, with its kernel path on.
    cfg = j_get_config(arch, smoke=True)
    params = j_get_model(cfg).init(cfg, jax.random.PRNGKey(0))
    cache = JPagedKVCache(cfg, JPagedCacheConfig(
        n_pages=256, page_size=4, use_pallas=True, interpret=True))
    loop = JServeLoop(cfg, cache, JServeConfig(max_batch=4,
                                               frag_threshold=0.2))
    rng = np.random.default_rng(0)
    for i in range(24):
        loop.submit(JRequest(rid=i, prompt_len=int(rng.integers(4, 32)),
                             max_new_tokens=int(rng.integers(4, 16))))
    lp0 = jax.tree.map(lambda a: a[0], params["layers"])["attn"]

    def decode_fn(seq_ids):
        x = jax.random.normal(jax.random.PRNGKey(loop.decode_steps),
                              (len(seq_ids), 1, cfg.d_model), jnp.float32)
        k = jnp.einsum("bsd,dhk->bshk", x, lp0["wk"])[:, 0]
        v = jnp.einsum("bsd,dhk->bshk", x, lp0["wv"])[:, 0]
        for i, s in enumerate(seq_ids):
            cache.write_token_kv(0, s, k[i], v[i])
        q = jnp.einsum("bsd,dhk->bshk", x, lp0["wq"])[:, 0]
        assert bool(jnp.isfinite(cache.attend(0, seq_ids, q)).all())

    loop.run(decode_fn, max_steps=5000)
    want = (f"completed={len(loop.done)}/24 decode_steps={loop.decode_steps} "
            f"compaction_steps={loop.compaction_steps} "
            f"compaction_dmas={cache.compaction_dmas} "
            f"alloc_failures={cache.alloc_failures}")
    assert line == want
