#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   into ``build/kernels/``; print the toolchain and the card.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes its paths give it (the serve driver's and the prefills' full
   widths, head_dim 96 for phi3-mini, a ragged f32 case for K3, mamba2's
   SMOKE widths and an initial state for K4; for K4-bwd, the backward of
   the SSD scan, mamba2-370m's training shape, the SMOKE widths with an
   initial state and a final state's gradient, also against autograd
   through the plain scan, and an overflowing decay, with two calls
   bit-identical), and time the kernel, the plain version and a library
   yardstick where one exists (K1 also at two long-context shapes, L-MHA
   and L-GQA, beside a launch floor; K3 at each of its three bf16 shapes,
   with its TFLOP/s; each of K4's three launches and K4-bwd's six by the
   profiler, and the route each K4-bwd case took: P = 64 at chunk 64 or
   128 on the tensor-core route, every other shape on the route of
   mma.sync).  The profiler checks that K1 and K2 are one kernel a call.
   K4 and K4-bwd are also held and timed at one card's heads of a model
   axis of 4: mamba2-370m's (2, 4096, 8 of 32 heads, P 64, N 128) and
   jamba's (1, 4096, 32 of 128, P 64, N 16).  The Mamba-2 layer's fused
   kernels (``ssd_fused``: the conv and dt, the gated norm, forward and
   backward) are held, with their plain versions, to an f64 evaluation
   at mamba2-370m.train's shape (8 x 4096) and timed beside their byte
   bound, and the whole stretch beside its plain composite.
3. Run the serve driver at full olmo-1b width (16 layers, d_model 2048) and
   check its counts and that it went through K1 (once a decode step) and K2
   (once a compaction).
4. Prefill olmo-1b at full width (batch 2, seq 4096, bf16) through
   ``build_prefill_step``, with K3 in every layer; check the chunked (K3)
   forward against the naive one in f32, and dense-cache decode
   (``build_decode_step``) against the chunked forward in f32.
5. Prefill starcoder2-3b at full width (30 layers, 24 heads over 2 KV
   heads), the GQA case of K3.
6. Profile one olmo-1b prefill and one serve run and print where their
   device time goes.
7. Prefill mamba2-370m at full width (48 layers, d_model 1024, batch 2, seq
   4096, bf16) with the SSD-scan kernel (K4) in every layer; check O(1)-state
   decode against the K4 forward in f32 across a chunk boundary; profile one
   prefill by part.
8. Train olmo-1b at full width (batch 2, seq 4096, bf16 compute, f32 params,
   remat "full", chunked attention) for 4 steps of ``build_train_step``:
   K3's forward twice a layer (forward and recompute) and its backward kernel
   (K3-bwd) once a layer; profile one step by part; check one f32 step of
   the chunked path (K3 and K3-bwd) against the naive one (einsum and
   autograd) at full width and 2 layers; run the train driver at SMOKE size
   and with the full config; take one more step twice, from the state and
   from a clone of it, and require the same bits in every leaf of params,
   moments and count and in the loss and grad norm.  K3-bwd is held
   against its plain version in phase 2, at olmo-1b's training shape,
   starcoder2-3b's GQA, phi3-mini's D = 96 and a ragged f32 case, and
   timed beside SDPA's backward.
9. Train mamba2-370m at full width (48 layers, d_model 1024, batch 2, seq
   4096, bf16 compute, f32 params, remat "full") for 4 steps of
   ``build_train_step``: K4 twice a layer (forward and recompute) and
   K4-bwd once a layer; profile one step by part; check one f32 step of
   the kernel path against autograd through the plain chunked scan at full
   width and 2 layers, held to f32's own spread; run the train driver with
   ``--arch mamba2-370m --smoke``.  One more step taken twice from the same
   state must give the same bits, as in phase 8.
10. The MoE family.  ``[moe layer]``: one granite-moe-3b-a800m MoE FFN
   layer at full width (d_model 1536, 40 experts, top 8, ff 512) on 8192
   tokens, forward and backward in f32 against the host CPU (tokens whose
   kept experts differ, near-ties, counted and left out), the dropped
   pairs counted, two runs bit-identical in f32 and bf16, the bf16 layer
   timed.  Then granite-moe-3b-a800m at full width: the prefill (batch 2,
   seq 4096, bf16, K3 once a layer); dense-cache decode against the
   chunked forward in f32 (32 tokens; the forward drops pairs that decode
   never does, so it is held before the first drop and to a forward whose
   capacity drops nothing); the serve driver with ``--full`` (K1 once a
   decode step, K2 once a compaction); 4 training steps (batch 2, seq
   4096, bf16 compute, f32 params, remat "full": K3 64 and K3-bwd 32
   launches a step), peak memory and one step profiled by part, the MoE's
   routing, dispatch, expert products and combine apart from attention and
   AdamW; one step taken twice from one state with the depth cut to 8 of
   32 layers (the whole state does not fit twice); the train driver at
   SMOKE size.  Last, grok-1-314b's prefill at full width cut to 2 of 64
   layers (batch 1, seq 2048: 8 experts of ff 32768, K3 at D 128 over 8 KV
   heads).  K3 and K3-bwd are held against their plain versions in phase 2
   at granite-moe's and grok-1's shapes too, and timed beside SDPA.
11. The hybrid, VLM and audio families (``[zoo]``).  jamba-v0.1-52b at
   full width (d_model 4096, 32 heads over 8, Mamba P 64 and N 16, chunk
   128) cut to 1 of 4 super-blocks (8 of 32 layers; the full model's
   51.5B f32 params do not fit a card): the prefill with all 16 experts
   (batch 2, seq 4096: K3 once, K4 once for each of the 7 Mamba
   positions), profiled by part; decode in f32 against the forward over
   two chunks, all three held to a forward with attention and scan in
   f64; 4 training steps with 2 of 16 experts (batch 1, seq 4096, remat
   "full": K3 2, K3-bwd 1, K4 14 and K4-bwd 7 launches a step), peak
   memory and a profile by part, and 5 steps from the seed taken twice
   to the same bits (the state fits the card once, not twice); one f32
   step's gradients of the kernels against their plain versions in f32
   and f64; the train driver at SMOKE size.  qwen2-vl-2b at full width
   (M-RoPE): the prefill (28 K3 launches), f32 decode, 4 training steps
   (K3 56 and K3-bwd 28 a step).  hubert-xlarge: a full-width forward
   (non-causal, D 80: no kernel) and the SMOKE train driver.  Phase 2
   holds and times K3 and K3-bwd at jamba's and qwen2-vl's shapes, K4
   and K4-bwd at jamba's.
12. The mesh and the parallel modules (``[parallel]``): olmo-1b trains at
   full width (batch 2, seq 4096, bf16 compute, f32 params, chunked
   attention) through ``build_train_step`` on ``make_host_mesh()`` under
   remat "dots_with_no_batch_dims", 4 steps (K3 32 and K3-bwd 16 launches
   a step, by the counters and by the profiler: K3's forward runs again
   in the backward pass, since no dispatch mode sees its launch), then
   under "full" and "none", each step's time by CUDA events and each
   policy's peak memory, which must order full < dots < none; one f32
   step at full width cut to 2 layers gives the same bits in the loss and
   every gradient under all three policies; ``int8_allreduce`` in a
   world-size-1 NCCL group (a FileStore in a temporary directory) on the
   embedding's gradient equals ``int8_quantize`` dequantized and the CPU
   function's result bit for bit, and is timed;
   ``examples/torch_serve_paged.py`` prints its twin's line; and the
   dry-run of every (arch × shape) cell on both production meshes
   (``python -m repro_torch.launch.dryrun --all --out ""`` and with
   ``--multi-pod``: one device's step on meta tensors in a fake process
   group of 256 or 512, host work, in two subprocesses started after the
   timed work) prints 62 OK lines and no FAIL.
13. The train step across processes (``[parallel dp]``): one process a
   card (``torch.cuda.device_count()`` of them, spawned) in an NCCL group,
   on ``make_host_mesh()``: olmo-1b at full width through the sharded
   ``build_train_step`` (global batch 2 a card, seq 4096, remat "full":
   the batch split by rows, params and AdamW moments as FSDP blocks, each
   layer's weights gathered when it runs and its gradient reduce-scattered
   in its backward), 4 steps, each step's time by CUDA events, each
   rank's peak memory, K3 32 and K3-bwd 16 launches a step by the
   counters and the profiler, and the profiler's NCCL kernels and
   device-to-device copies; then each rank counts the collectives of one
   more step (calls and result bytes by kind, with the dry-run's
   counter), which must equal the dry-run's plan of that rank on the same
   mesh and global batch (computed on meta tensors in a fake group, in a
   subprocess, before the group starts).  With one card, one sharded step
   from a state must give the one-process step's bits from a clone of it,
   and each step's own peak is printed beside the other's; that step runs
   the split path of a model axis of 1 (heads, FFN columns, vocabulary and
   embedding rows in one block each, ``to_model``/``from_model`` and the
   vocabulary-parallel loss, counted on a ``[parallel tp] world 1`` line,
   with the per-layer gathers); with more, an f32 step at 2 layers must
   give one process's loss within the f32 spread, its grad norm within
   1e-4 and, gathered, its params within the f32 bounds.  On 2 or more
   cards an olmo-1b step on the (pod, data, model) mesh (2, cards / 2, 1)
   gives the data mesh's first loss on the same batch within 1e-5
   relative; on 4 or more, phi3-medium-14b trains 3 steps at full width
   (40 layers, global batch 4 × 4096, remat "full"); with one card both
   print why they wait.
   Then the train driver under torchrun at SMOKE size: a crash after step
   5, the resume and an uninterrupted run, with the same losses.
   Then mamba2-370m at full width (48 layers) through the sharded train
   step, global batch 2 a card × 4096, remat "full": at one card one step
   gives the one-process step's bits through the split path of a model
   axis of 1 (the Mamba-2 heads, ``w_in``'s blocks gathered by
   ``gather_blocks``: counted on a ``[parallel tp] world 1`` line; the
   gated norm's row is whole there, so it runs fused, with no ``psum``);
   with more cards an f32 step at 2
   layers is held against the f64 one-process step (``dp_f32_check``);
   4 steps timed by CUDA events with K4 96 and K4-bwd 48 launches a step
   by the counters and the profiler, and each rank's peak.  Then the
   decode step across processes (``build_decode_step`` on the mesh: the
   KV cache split along its sequence, each token's attention merged by
   log-sum-exp; the Mamba-2 heads' SSM state split): olmo-1b and
   mamba2-370m at full width, batch 8, cache max_seq 4096, ragged
   lengths, 4 f32 steps whose gathered logits are held against the
   one-process decode in f64 within twice the one-process f32 decode's
   own distance from it, then 16 bf16 steps timed by host wall beside
   the one-process decode, and one profiled; at one card also jamba cut
   to 1 of 4 blocks with 2 of 16 experts, in f32.
   ``tools/parallel_dp.py --model M`` runs the phase on a (cards / M, M)
   mesh, with the mesh's prefill and a granite-moe-3b-a800m step
   (``--runs`` picks the parts); phase 2 holds and times K3 and K3-bwd at
   one card's heads of a model axis of 4 (olmo-1b 4 of 16, granite-moe 6
   of 24 over 2), and K4 and K4-bwd at mamba2-370m's and jamba's.
14. Checkpoints (``[checkpoint]``): crash and resume through the train
   driver on the card for olmo-1b and mamba2-370m at SMOKE size (crash
   after step 5 of 8 with a checkpoint every 3 steps, resume, and an
   uninterrupted run): the resumed run prints ``resumed from step 5`` and
   the losses of steps 6-7 of the uninterrupted one, and both final
   checkpoints restore into card tensors with the same bits in every leaf.
   Then time a save, a recovery and a restore into card tensors of the
   full-width mamba2-370m training state (params and both AdamW moments,
   f32) cut to 2 of its 48 layers: one save, as the engine's save slows
   down as the store fills (``tools/ckpt_throughput.py`` takes more).

The last lines are a JSON object per kernel (with its launches on the
phase 11, 12 and 13 paths under ``paths``), the card's name and power limit, and
``{"ok": true, "device": {...}}``.  There is no CPU fallback: with
no card the script exits non-zero before doing anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# granite-moe-3b-a800m's full-width training step peaks at 69.09 of 79.18
# GiB; the caching allocator's fragmentation can hold more than the rest
# (12.4 GiB reserved and unused in one run), so segments grow in place.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The published H100 SXM peaks (HBM3 rate, f32 outside the tensor cores,
# dense TF32 and bf16 on the tensor cores) and each kernel's least work:
# bounds are stated against them.
from repro_torch.kernels.cost import (  # noqa: E402
    BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S, TF32_FLOPS,
    attention_bwd_flops_bytes, flash_attention_flops_bytes,
    gather_flops_bytes, paged_attention_flops_bytes, ssd_bwd_flops_bytes,
    ssd_flops_bytes)

SERVE_FULL = ["--arch", "olmo-1b", "--full"]
EXPECT_FULL = ("completed=24/24 decode_steps=62 compaction_steps=12 "
               "compaction_dmas=2880 alloc_failures=0")
PREFILL = (2, 4096)            # olmo-1b, mamba2-370m, granite-moe prefill
GROK_PREFILL = (1, 2048)       # grok-1-314b prefill (batch, seq), 2 layers
TRAIN = (2, 4096)              # training (batch, seq), every model but jamba
JAMBA_TRAIN = (1, 4096)        # jamba-v0.1-52b training (batch, seq)
TRAIN_STEPS = 4
SERVE_GRANITE = ["--arch", "granite-moe-3b-a800m", "--full"]
# The traffic and pages are olmo's, so are the counts; compaction_dmas is
# 90 copies a plane x n_layers x 2 planes (32 layers).
EXPECT_GRANITE = ("completed=24/24 decode_steps=62 compaction_steps=12 "
                  "compaction_dmas=5760 alloc_failures=0")
SERVE_SMOKE = ["--arch", "olmo-1b"]
EXPECT_SMOKE = ("completed=24/24 decode_steps=62 compaction_steps=12 "
                "compaction_dmas=360 alloc_failures=0")
SEED = 0
# K4 and K4-bwd at one card's heads of a model axis of 4 ([parallel tp]):
# mamba2-370m's 8 of 32, jamba's 32 of 128
MAMBA_LOCAL = "mamba2-370m local heads (8 of 32, model axis 4)"
JAMBA_LOCAL = "jamba-v0.1-52b local heads (32 of 128, model axis 4)"
# the cases phase 2 times: the first (the record), jamba's and the local
K4_TIMED = ("jamba-v0.1-52b prefill", "jamba-v0.1-52b training",
            MAMBA_LOCAL, JAMBA_LOCAL)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


# The spin lasts at least its nominal time on any clock up to 2 GHz.
SPIN_CYCLES_PER_MS = 2.0e6


def device_ms(label: str, fn, iters: int = 50) -> float:
    """Device time of one call, free of host overhead: the calls are queued
    behind a spin kernel, then run back to back between two events."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    spin_ms = 2 * (time.perf_counter() - t) * 1e3 + 5
    for _ in range(3):
        torch.cuda.synchronize()
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        e1.record()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t) * 1e3
        e2.record()
        torch.cuda.synchronize()
        if host_ms < e0.elapsed_time(e1):
            break
        spin_ms *= 4
    else:
        print(f"  note: {label}: queueing outlasted the spin, so this time "
              "includes host gaps", flush=True)
    return e1.elapsed_time(e2) / iters


def kernel_label(mangled: str) -> str:
    """'flash_attention_bwd_dq_wgmma_kernel<128>' from a mangled name: the
    first length-prefixed name that ends in _kernel, and its template's
    integer and float arguments."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        start = m.start() + len(m.group(1))
        name = mangled[start:start + int(m.group(1))]
        if name.endswith("_kernel"):
            args = re.match(r"I(.*?E)E", mangled[start + len(name):])
            if args is None:
                return name
            parts = re.findall(r"Li(\d+)E|^(f)|(__nv_bfloat16)", args.group(1))
            return name + "<" + ", ".join(
                n or ("float" if f else "bf16") for n, f, _ in parts) + ">"
    return mangled


def phase_build():
    """Builds every kernel; prints, per kernel, the registers ptxas gave it
    and its spills, and any note ptxas made about wgmma."""
    from repro_torch.kernels import _build
    t = time.perf_counter()
    reports = _build.build_all()
    print(f"[build] {len(reports)} libraries built in "
          f"{time.perf_counter() - t:.1f}s into {_build.BUILD_DIR}")
    for name, log in reports.items():
        label, spills = None, ""
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                label = kernel_label(entry.group(1))
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line and label is not None:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"[build] {name}: {label}: {regs} registers; {spills}")
            elif "GMMA" in line or "serialized" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"[build] {sh(_build.nvcc(), '--version').splitlines()[-1]}")
    print(f"[build] device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)


def paged_inputs(gen, rng, b, h, hkv, d, p_total, page, n_pages, q_dtype,
                 kv_dtype):
    dev = "cuda"
    q = torch.randn((b, h, d), generator=gen, device=dev).to(q_dtype)
    k_pool = torch.randn((p_total, page, hkv, d), generator=gen,
                         device=dev).to(kv_dtype)
    v_pool = torch.randn((p_total, page, hkv, d), generator=gen,
                         device=dev).to(kv_dtype)
    pt = np.full((b, n_pages), -1, np.int32)
    lengths = np.zeros((b,), np.int32)
    for i in range(b):
        used = int(rng.integers(1, n_pages + 1))
        pt[i, :used] = rng.choice(p_total, size=used, replace=False)
        lengths[i] = int(rng.integers((used - 1) * page + 1, used * page + 1))
    return (q, k_pool, v_pool, torch.from_numpy(pt).to(dev),
            torch.from_numpy(lengths).to(dev))


def phase_paged_attention():
    """K1 against its plain version; returns the record of the serve
    driver's case (f32 q over a bf16 pool, olmo-1b widths)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    gen = torch.Generator("cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    # (label, B, H, Hkv, D, P, page, n_pages, q dtype, pool dtype, tol)
    cases = [
        ("olmo-1b f32q/bf16", 4, 16, 16, 128, 256, 4, 12, f32, bf16, 2e-3),
        ("olmo-1b bf16/bf16", 4, 16, 16, 128, 256, 4, 12, bf16, bf16, 3e-2),
        ("phi3-mini f32q/bf16", 4, 32, 32, 96, 256, 4, 12, f32, bf16, 2e-3),
        ("phi3-mini bf16/bf16", 4, 32, 32, 96, 256, 4, 12, bf16, bf16, 3e-2),
    ]
    record = None
    for label, b, h, hkv, d, p_total, page, n_pages, qd, kvd, tol in cases:
        args = paged_inputs(gen, rng, b, h, hkv, d, p_total, page, n_pages,
                            qd, kvd)
        if label.startswith("phi3-mini f32q"):
            args[4][0] = 0           # a row with no valid slot: zeros
        if label.startswith("phi3-mini bf16"):
            # an unmapped page in the middle of a full table gets no weight
            args[3][1] = torch.randperm(p_total, generator=gen,
                                        device="cuda")[:n_pages]
            args[3][1, 1] = -1
            args[4][1] = n_pages * page
        out = pa.paged_attention(*args)
        torch.cuda.synchronize()
        want = ref.paged_attention_ref(*args)
        diff = (out.float() - want.float()).abs()
        err = float(diff.max())
        if out.dtype != qd or out.shape != args[0].shape:
            fail(f"paged_attention {label}: got {out.dtype}{tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            fail(f"paged_attention {label}: non-finite output")
        if bool((diff > tol + tol * want.float().abs()).any()):
            fail(f"paged_attention {label}: max abs err {err:.3g} > tol {tol}")
        if label.startswith("phi3-mini f32q") and bool(out[0].any()):
            fail("paged_attention: a zero-length row is not zeros")
        print(f"[K1] {label}: max_abs_err={err:.3g} (tol {tol})", flush=True)
        if record is not None:
            continue
        # The serve driver's case: time it and bound it.
        q, k_pool, v_pool, pt, lengths = args
        if kernels_per_call(lambda: pa.paged_attention(*args),
                            "paged_attention") != 1:
            fail(f"paged_attention {label}: not one kernel a call")
        ms = device_ms("K1 kernel", lambda: pa.paged_attention(*args))
        # ~20 small kernels a call: few calls, or they fill the launch queue
        plain_ms = device_ms("K1 plain", lambda: ref.paged_attention_ref(*args),
                         iters=10)
        safe = pt.clamp(min=0).long()
        kg = k_pool[safe].reshape(b, -1, hkv, d).transpose(1, 2).to(qd)
        vg = v_pool[safe].reshape(b, -1, hkv, d).transpose(1, 2).to(qd)
        pos = torch.arange(n_pages * page, device="cuda")
        mask = (pos[None] < lengths[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        library_ms = device_ms("K1 SDPA", lambda: torch.nn.functional
                           .scaled_dot_product_attention(q4, kg, vg,
                                                         attn_mask=mask))
        tokens = int(lengths.sum())
        flops, nbytes = paged_attention_flops_bytes(
            b, h, hkv, d, tokens, pt.shape[1], q.element_size(),
            k_pool.element_size())
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = flops / F32_FLOPS * 1e3
        record = dict(
            name="paged_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:89",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(byte_ms, op_ms),
            bound_by="bytes" if byte_ms >= op_ms else "operations",
            library_ms=library_ms)
        print(f"[K1] {label}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              f"SDPA over gathered K/V {library_ms:.5f} ms; {nbytes} bytes, "
              f"{flops} flops -> bound {record['bound_ms']:.6f} ms "
              f"({record['bound_by']})", flush=True)
    floor_ms = launch_floor_ms()
    print(f"[K1] launch floor (a one-element zero_()): {floor_ms:.5f} ms; "
          f"K1 at the serve shape {record['ms']:.5f} ms, its byte bound "
          f"{record['bound_ms']:.6f} ms sits below it", flush=True)
    record["long"] = {}
    for label, b, h, hkv, lo, copies in LONG_PAGED:
        record["long"][label] = long_paged_attention(pa, ref, gen, rng, label,
                                                     b, h, hkv, lo, copies)
    return record


# The long-context K1 shapes: (label, B, H, Hkv, least length, copies), at
# D 128, page 16, f32 q over a bf16 pool, with a padded context of 4096.
# L-MHA is olmo-1b's widths with lengths drawn in 1024-4096; L-GQA is
# starcoder2-3b's (24 heads over 2) at 4096 for every row.  L-GQA's K/V
# (16.8 MB) would stay in the 50 MB L2 between back-to-back calls, so it is
# timed over 4 copies of its pages and tables, taken in turn (67 MB).
LONG_PAGED = [("L-MHA", 8, 16, 16, 1024, 1), ("L-GQA", 4, 24, 2, 4096, 4)]
LONG_CONTEXT, LONG_PAGE, LONG_D = 4096, 16, 128


def launch_floor_ms() -> float:
    """Device time of the smallest PyTorch kernel: below it, a kernel's
    byte bound says nothing."""
    x = torch.zeros((1,), device="cuda")
    return device_ms("launch floor", x.zero_, iters=200)


def kernels_per_call(call, what: str, calls: int = 5, tries: int = 3) -> int:
    """Device kernels whose name holds ``what`` that one call launches,
    counted by the profiler over a few calls.  The profiler now and then
    loses the record of a short kernel (on the H100, 2 of K2's 5 in one
    run), which can only lower the count: a count below one a call is
    taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        n = sum(c for name, (_, c) in device_time_by_name(prof).items()
                if what in name)
        if n >= calls:
            break
        print(f"[profile] {what}: the profiler shows {n} kernels over "
              f"{calls} calls; counting again", flush=True)
    if n % calls:
        fail(f"{what}: {n} kernels over {calls} calls")
    return n // calls


def long_paged_attention(pa, ref, gen, rng, label, b, h, hkv, lo, copies):
    """K1 at a long-context shape: held against its plain version at 2e-3,
    timed beside the plain version and SDPA over pre-gathered K/V; returns
    its times and bound."""
    d, page, n_pages = LONG_D, LONG_PAGE, LONG_CONTEXT // LONG_PAGE
    p_total = copies * b * n_pages
    q = torch.randn((b, h, d), generator=gen, device="cuda")
    k_pool, v_pool = (torch.randn((p_total, page, hkv, d), generator=gen,
                                  device="cuda").to(torch.bfloat16)
                      for _ in range(2))
    lengths_np = rng.integers(lo, LONG_CONTEXT + 1, size=b).astype(np.int32)
    pages = rng.permutation(p_total).reshape(copies, b, n_pages)
    used = -(-lengths_np // page)
    tables = np.where(np.arange(n_pages)[None, None] < used[None, :, None],
                      pages, -1).astype(np.int32)
    tables = [torch.from_numpy(t).cuda() for t in tables]
    lengths = torch.from_numpy(lengths_np).cuda()
    args = (q, k_pool, v_pool, tables[0], lengths)
    tol = 2e-3
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_attention_ref(*args)
    diff = (out - want).abs()
    err = float(diff.max())
    if not bool(torch.isfinite(out).all()) or \
            bool((diff > tol + tol * want.abs()).any()):
        fail(f"paged_attention {label}: max abs err {err:.3g} > tol {tol}")
    del want, diff
    per_call = kernels_per_call(lambda: pa.paged_attention(*args),
                                "paged_attention")
    if per_call != 1:
        fail(f"paged_attention {label}: {per_call} kernels a call")
    turn = iter(range(10 ** 9))
    ms = device_ms(f"K1 {label}", lambda: pa.paged_attention(
        q, k_pool, v_pool, tables[next(turn) % copies], lengths))
    plain_ms = device_ms(f"K1 plain {label}",
                         lambda: ref.paged_attention_ref(*args), iters=3)
    safe = tables[0].clamp(min=0).long()
    kg = k_pool[safe].reshape(b, -1, hkv, d).transpose(1, 2).float()
    vg = v_pool[safe].reshape(b, -1, hkv, d).transpose(1, 2).float()
    pos = torch.arange(LONG_CONTEXT, device="cuda")
    mask = (pos[None] < lengths[:, None])[:, None, None, :]
    library_ms = device_ms(f"K1 SDPA {label}", lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               q[:, :, None, :], kg, vg, attn_mask=mask,
                               enable_gqa=h != hkv), iters=10)
    del kg, vg
    tokens = int(lengths_np.sum())
    flops, nbytes = paged_attention_flops_bytes(b, h, hkv, d, tokens,
                                                n_pages, 4, 2)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / F32_FLOPS * 1e3
    bound_ms = max(byte_ms, op_ms)
    print(f"[K1] {label} (B,H,Hkv,D)=({b},{h},{hkv},{d}) page {page}, "
          f"{tokens} tokens, f32q/bf16: max_abs_err={err:.3g} (tol {tol}), "
          f"{per_call} kernel a call; kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, SDPA over gathered K/V {library_ms:.5f} ms; "
          f"{nbytes} bytes, {flops} flops -> bound {bound_ms:.6f} ms "
          f"({'bytes' if byte_ms >= op_ms else 'operations'}), kernel at "
          f"{bound_ms / ms:.1%} of it ({ms / bound_ms:.2f}x)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, max_abs_err=err)


def phase_gc_compact():
    """K2 against its plain version on the full-width pool; returns its
    record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import gc_compact, ops, ref
    cfg = get_config("olmo-1b")
    n_pages, page, bp = 256, 4, 4
    gen = torch.Generator("cuda").manual_seed(SEED + 1)
    pool = torch.randn((cfg.n_layers, 2, n_pages, page, cfg.kv_heads,
                        cfg.head_dim), generator=gen,
                       device="cuda").to(cfg.compute_dtype)
    # Live pages as the serve driver leaves them: the runs of four live
    # sequences of 3-12 pages, between the holes of finished ones.
    rng = np.random.default_rng(SEED)
    valid = np.zeros(n_pages, bool)
    start = 0
    for _ in range(4):
        start += int(rng.integers(1, 9))
        run = int(rng.integers(3, 13))
        valid[start:start + run] = True
        start += run
    n_live = int(valid.sum())
    src = pool.view(cfg.n_layers * 2, n_pages, page, -1)
    # As PagedKVCache.compact does: gather the live pages, write them back
    # over the front; the tail keeps its old pages.
    dst = src.new_empty((src.shape[0], n_live) + src.shape[2:])
    _, new_index, dmas = ops.compact_pages(src, valid, bp, out=dst)
    new_pool = pool.clone()
    new_pool.view(src.shape)[:, :n_live] = dst
    torch.cuda.synchronize()
    perm = np.arange(n_pages)
    for old, new in enumerate(new_index):
        if new >= 0:
            perm[new] = old
    want = pool[:, :, torch.from_numpy(perm).cuda()]
    if not torch.equal(new_pool, want):
        fail("gc_compact: compacted pool differs from the plain permutation")
    err = float((new_pool.float() - want.float()).abs().max())
    blocks, tail, _ = ops.compact_plan(valid, bp)
    print(f"[K2] olmo-1b pool {tuple(pool.shape)} {pool.dtype}: {n_live} live "
          f"pages, {dmas} copies per plane ({len(blocks)} blocks of {bp}, "
          f"{len(tail)} single pages), bit-exact over {cfg.n_layers * 2} "
          "planes and the kept tail", flush=True)

    units, _, _ = ops.compact_units(valid, bp)

    def kernel():
        gc_compact.gather_page_units(src, units, dst)

    if kernels_per_call(kernel, "gather_page_units") != 1:
        fail("gc_compact: not one kernel a compaction")
    order = np.concatenate([np.arange(b * bp, (b + 1) * bp) for b in blocks]
                           + [tail]).astype(np.int64)
    idx = torch.from_numpy(order).cuda()
    ms = device_ms("K2 kernel", kernel)
    plain_ms = device_ms("K2 plain", lambda: ref.gather_pages_ref(src, idx))
    library_ms = device_ms("K2 index_select",
                       lambda: torch.index_select(src, 1, idx))
    _, nbytes = gather_flops_bytes(len(order), len(blocks) + len(tail),
                                   src.shape[0], page, src.shape[-1],
                                   src.element_size())
    record = dict(
        name="gather_page_blocks", route="cuda",
        source="src/repro_torch/kernels/csrc/gc_compact.cu",
        replaces="src/repro/kernels/gc_compact.py:45",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=library_ms)
    print(f"[K2] kernel (1 launch, {len(units)} units) {ms:.5f} ms, plain {plain_ms:.5f} ms, "
          f"index_select {library_ms:.5f} ms; {nbytes} bytes -> bound "
          f"{record['bound_ms']:.6f} ms (bytes); launch floor "
          f"{launch_floor_ms():.5f} ms (a one-element zero_())", flush=True)
    return record


def phase_flash_attention():
    """K3 against its plain version at the prefills' shapes, each bf16 one
    timed beside SDPA and its bound; returns the record of the olmo-1b
    prefill case."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    f32, bf16 = torch.float32, torch.bfloat16
    # Tolerance: 2e-3 for f32 (the SIMT kernel and the plain version's
    # einsums sum in different orders); 2e-2 for bf16 (the plain version
    # rounds the scores to bf16, the tensor-core kernel keeps them in f32;
    # both round the softmax weights to bf16 before the product with V).
    # (label, B, S, H, Hkv, D, dtype, causal, tol)
    cases = [
        ("olmo-1b prefill", *PREFILL, 16, 16, 128, bf16, True, 2e-2),
        ("starcoder2-3b prefill", 1, 2048, 24, 2, 128, bf16, True, 2e-2),
        ("phi3-mini D=96", 1, 2048, 32, 32, 96, bf16, True, 2e-2),
        ("granite-moe-3b-a800m prefill", *PREFILL, 24, 8, 64, bf16, True,
         2e-2),
        ("grok-1-314b prefill", *GROK_PREFILL, 48, 8, 128, bf16, True, 2e-2),
        ("jamba-v0.1-52b prefill", *PREFILL, 32, 8, 128, bf16, True, 2e-2),
        ("qwen2-vl-2b prefill", *PREFILL, 12, 2, 128, bf16, True, 2e-2),
        # one card's heads of a model axis of 4 ([parallel tp])
        ("olmo-1b prefill, 4 of 16 heads", *PREFILL, 4, 4, 128, bf16, True,
         2e-2),
        ("granite-moe-3b-a800m prefill, 6 of 24 heads", *PREFILL, 6, 2, 64,
         bf16, True, 2e-2),
        ("ragged f32 non-causal", 1, 1000, 8, 2, 64, f32, False, 2e-3),
    ]
    record = None
    for label, b, s, h, hkv, d, dt, causal, tol in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in [(b, s, h, d), (b, s, hkv, d),
                                 (b, s, hkv, d)])
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        diff = (out.float() - want.float()).abs()
        err = float(diff.max())
        if out.dtype != dt or out.shape != q.shape:
            fail(f"flash_attention {label}: got {out.dtype}{tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            fail(f"flash_attention {label}: non-finite output")
        if bool((diff > tol + tol * want.float().abs()).any()):
            fail(f"flash_attention {label}: max abs err {err:.3g} > tol {tol}")
        print(f"[K3] {label} (B,S,H,Hkv,D)=({b},{s},{h},{hkv},{d}) {dt} "
              f"causal={causal}: max_abs_err={err:.3g} (tol {tol})",
              flush=True)
        del want, diff
        if dt != bf16:
            continue
        ms = device_ms(f"K3 kernel {label}",
                       lambda: fa.flash_attention(q, k, v), iters=20)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = device_ms(f"K3 SDPA {label}",
                               lambda: F.scaled_dot_product_attention(
                                   qt, kt, vt, is_causal=True,
                                   enable_gqa=h != hkv), iters=20)
        # q, k and v read once, the output (q's size) written once
        flops, nbytes = flash_attention_flops_bytes(b, s, h, hkv, d,
                                                    q.element_size())
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = flops / BF16_FLOPS * 1e3
        bound_ms = max(byte_ms, op_ms)
        bound_by = "bytes" if byte_ms >= op_ms else "operations"
        print(f"[K3] {label}: kernel {ms:.4f} ms at "
              f"{flops / ms / 1e9:.1f} TFLOP/s, SDPA {library_ms:.4f} ms at "
              f"{flops / library_ms / 1e9:.1f} TFLOP/s; {nbytes} bytes, "
              f"{flops} flops -> bound {bound_ms:.6f} ms ({bound_by})",
              flush=True)
        if record is not None:
            continue
        plain_ms = device_ms("K3 plain",
                             lambda: ref.flash_attention_ref(q, k, v),
                             iters=3)
        record = dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:78",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms)
        print(f"[K3] {label}: plain {plain_ms:.4f} ms", flush=True)
    return record


def phase_flash_attention_bwd():
    """K3-bwd against its plain version (the explicit formulas in f32) on
    the same out and lse, at the training shapes; two calls must give the
    same bits.  Each bf16 case is timed beside SDPA's backward, with its
    TFLOP/s, its share of the bound and each of its launches; the olmo-1b
    case also beside the plain version, and returns its record."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator("cuda").manual_seed(SEED + 4)
    f32, bf16 = torch.float32, torch.bfloat16
    # Tolerance, of the largest of dq, dk and dv.  f32: kernel and plain
    # version take every product in f32 from the same values and sum in
    # other orders, ~1e-6 (held to 1e-4).  bf16: outputs rounded to bf16
    # (2^-9 relative), and at D = 64, 96 and 128 the kernel rounds P and dS
    # to bf16 before their products on the tensor cores, as the forward
    # rounds P (held to 1e-2).
    # (label, B, S, H, Hkv, D, dtype, causal, tol)
    cases = [
        ("olmo-1b training", *PREFILL, 16, 16, 128, bf16, True, 1e-2),
        ("starcoder2-3b GQA", 1, 2048, 24, 2, 128, bf16, True, 1e-2),
        ("phi3-mini D=96", 1, 2048, 32, 32, 96, bf16, True, 1e-2),
        ("granite-moe-3b-a800m training", *TRAIN, 24, 8, 64, bf16, True,
         1e-2),
        ("grok-1-314b GQA", *GROK_PREFILL, 48, 8, 128, bf16, True, 1e-2),
        ("jamba-v0.1-52b training", *JAMBA_TRAIN, 32, 8, 128, bf16, True,
         1e-2),
        ("qwen2-vl-2b training", *TRAIN, 12, 2, 128, bf16, True, 1e-2),
        # one card's heads of a model axis of 4 ([parallel tp])
        ("olmo-1b training, 4 of 16 heads", *TRAIN, 4, 4, 128, bf16, True,
         1e-2),
        ("granite-moe-3b-a800m training, 6 of 24 heads", *TRAIN, 6, 2, 64,
         bf16, True, 1e-2),
        ("ragged f32 causal", 1, 200, 8, 2, 64, f32, True, 1e-4),
        ("ragged f32 full", 1, 200, 8, 2, 64, f32, False, 1e-4),
    ]
    record = None
    for label, b, s, h, hkv, d, dt, causal, tol in cases:
        q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                         .to(dt) for shape in [(b, s, h, d), (b, s, hkv, d),
                                               (b, s, hkv, d), (b, s, h, d)])
        out, lse = fa._forward(q, k, v, causal, True)
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal)
        torch.cuda.synchronize()
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)
        scale = max(float(w.float().abs().max()) for w in want)
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.dtype != dt or g.shape != w.shape:
                fail(f"flash_attention_bwd {label}: {name} is "
                     f"{g.dtype}{tuple(g.shape)}")
            if not bool(torch.isfinite(g).all()):
                fail(f"flash_attention_bwd {label}: non-finite {name}")
            errs[name] = float((g.float() - w.float()).abs().max())
            if errs[name] > tol * scale:
                fail(f"flash_attention_bwd {label}: {name} max abs err "
                     f"{errs[name]:.3g} > {tol} x {scale:.3g}")
        del want
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal)
        same = all(torch.equal(g, g2) for g, g2 in zip(got, again))
        print(f"[K3 bwd] {label} (B,S,H,Hkv,D)=({b},{s},{h},{hkv},{d}) {dt} "
              f"causal={causal}: max_abs_err "
              + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
              + f" (tol {tol} x {scale:.3g}); two calls bit-identical: "
              f"{same}", flush=True)
        if not same:
            fail(f"flash_attention_bwd {label}: two calls differ")
        del got, again
        if dt != bf16:
            continue
        ms = device_ms(f"K3-bwd kernel {label}", lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, dout, causal), iters=5)
        # SDPA's backward alone, a yardstick: its graph is built once, and
        # each timed call takes the gradients of the same output again.
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=h != hkv)
        dot = dout.transpose(1, 2)
        library_ms = device_ms(f"K3-bwd SDPA backward {label}",
                               lambda: torch.autograd.grad(
                                   o, (qt, kt, vt), dot, retain_graph=True),
                               iters=10)
        del o, qt, kt, vt
        flops, nbytes = attention_bwd_flops_bytes(q, k)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = flops / BF16_FLOPS * 1e3
        bound_ms = max(byte_ms, op_ms)
        bound_by = "bytes" if byte_ms >= op_ms else "operations"
        print(f"[K3 bwd] {label}: kernel {ms:.4f} ms at "
              f"{flops / ms / 1e9:.1f} TFLOP/s, SDPA backward "
              f"{library_ms:.4f} ms at {flops / library_ms / 1e9:.1f} "
              f"TFLOP/s; {nbytes} bytes, {flops} flops -> bound "
              f"{bound_ms:.6f} ms ({bound_by}); kernel at "
              f"{ms / bound_ms:.2f}x its bound", flush=True)
        bwd_launch_times(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, dout, causal))
        if record is not None:
            continue
        plain_ms = device_ms("K3-bwd plain", lambda: ref.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal), iters=2)
        print(f"[K3 bwd] {label}: plain {plain_ms:.4f} ms", flush=True)
        record = dict(
            name="flash_attention_bwd", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            replaces="src/repro/models/modules.py:207",
            max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return record


def bwd_launch_times(call, calls: int = 3):
    """Device time of each of K3-bwd's launches (delta, dk/dv, dq, and the
    sum of dk/dv partials where the group is split over CTAs), by kernel
    name from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    by_name = {name: v for name, v in device_time_by_name(prof).items()
               if "flash_attention_bwd" in name}
    total = sum(us for us, _ in by_name.values())
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"[K3 bwd]   {us / n / 1e3:.4f} ms a launch "
              f"({100 * us / total:.1f}%) x{n // calls} a call: {name[:80]}",
              flush=True)


def phase_ssd_scan():
    """K4 against its plain version (and the sequential recurrence on a
    small case); returns the record of the mamba2-370m prefill case."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    # Tolerance: f32 inputs and outputs, sums in another order and the
    # kernel's products in split TF32 (each operand split into two TF32
    # parts, hi.hi + hi.lo + lo.hi), so 1e-4 of the plain output's largest
    # magnitude, for y and the final state alike.
    tol = 1e-4
    # (label, B, S, H, P, N, chunk, dt range, initial state, sequential too)
    # dt 0.70-0.82 with a near -0.95 is the decay at mamba2-370m's init
    # (about -0.72 a step: exp over the upper triangle would overflow);
    # small dt keeps a long memory, so the carried state matters.  The
    # first case gives the record; jamba's (N = 16, byte-bound) is timed
    # too.
    cases = [
        ("mamba2-370m prefill", *PREFILL, 32, 64, 128, 128, (0.70, 0.82),
         False, False),
        ("jamba-v0.1-52b prefill", *PREFILL, 128, 64, 16, 128, (0.1, 0.9),
         False, False),
        # one card's heads on a model axis of 4 ([parallel tp])
        (MAMBA_LOCAL, *TRAIN, 8, 64, 128, 128, (0.70, 0.82), False, False),
        (JAMBA_LOCAL, *JAMBA_TRAIN, 32, 64, 16, 128, (0.1, 0.9), False,
         False),
        ("mamba2 SMOKE widths", 2, 256, 8, 16, 16, 16, (0.1, 0.9), False,
         False),
        ("initial state", 2, 1024, 32, 64, 128, 128, (0.001, 0.05), True,
         False),
        ("sequential oracle", 1, 512, 4, 64, 128, 128, (0.01, 0.1), False,
         True),
    ]
    record = None
    for label, b, s, h, p, n, chunk, (lo, hi), with_state, seq in cases:
        x = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dt = lo + (hi - lo) * torch.rand((b, s, h), generator=gen,
                                         device="cuda")
        a = -(0.9 + 0.1 * torch.rand((h,), generator=gen, device="cuda"))
        bm, cm = (torch.randn((b, s, n), generator=gen, device="cuda")
                  for _ in range(2))
        init = (torch.randn((b, h, p, n), generator=gen, device="cuda")
                if with_state else None)
        args = (x, dt, a, bm, cm, chunk, init)
        y, st = ss.ssd_scan(*args)
        torch.cuda.synchronize()
        oracles = [("chunked", ref.ssd_chunked_ref(*args))]
        if seq:
            oracles.append(("sequential", ref.ssd_scan_ref(*args[:5])))
        errs = []
        for name, (want_y, want_st) in oracles:
            for what, got, want in (("y", y, want_y), ("state", st, want_st)):
                scale = float(want.abs().max())
                err = float((got - want).abs().max())
                if not bool(torch.isfinite(got).all()) or err > tol * scale:
                    fail(f"ssd_scan {label}: {what} against the {name} "
                         f"version: max abs err {err:.3g} > {tol} x {scale:.3g}")
                errs.append(f"{what} vs {name} {err:.3g} (|max| {scale:.3g})")
        print(f"[K4] {label} (B,S,H,P,N)=({b},{s},{h},{p},{n}) chunk {chunk}"
              f"{' with initial state' if with_state else ''}: max_abs_err "
              f"{', '.join(errs)} (tol {tol} x |max|)", flush=True)
        if record is not None and label not in K4_TIMED:
            continue
        want_y = oracles[0][1][0]
        err = float((y - want_y).abs().max())
        del oracles
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ss.ssd_scan(*args)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        print(f"[K4] {label}: one call takes {extra / 2**20:.1f} MiB of device "
              f"memory at its peak (y, the final state and the workspace of "
              f"chunk states)", flush=True)
        ms = device_ms("K4 kernel", lambda: ss.ssd_scan(*args), iters=20)
        plain_ms = device_ms("K4 plain", lambda: ref.ssd_chunked_ref(*args),
                             iters=3)
        flops, nbytes = ssd_flops_bytes(b, s, h, p, n, with_state)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # The products run as split TF32: three TF32 products for each
        # f32 one, on the tensor cores.
        op_ms = 3 * flops / TF32_FLOPS * 1e3
        case = dict(
            name="ssd_scan", route="cuda",
            source="src/repro_torch/kernels/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:82",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(byte_ms, op_ms),
            bound_by="bytes" if byte_ms >= op_ms else "operations",
            library_ms=None)
        record = record or case
        print(f"[K4] {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              "no library call; "
              f"{nbytes} bytes, {flops} flops -> bound "
              f"{case['bound_ms']:.6f} ms ({case['bound_by']}: 3 x the "
              f"flops at {TF32_FLOPS / 1e12:.0f} TFLOP/s TF32, the bytes at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s; {flops / F32_FLOPS * 1e3:.6f} "
              f"ms on the f32 SIMT units); kernel at "
              f"{flops / ms / 1e9:.2f} TFLOP/s of that work", flush=True)
        ssd_launch_times(lambda: ss.ssd_scan(*args))
    return record


def ssd_launch_times(call, calls: int = 10, key="ssd_scan", tag="[K4]"):
    """Device time of each of K4's launches (chunk states, state passing,
    chunk scan), or of K4-bwd's (key "ssd_bwd"), or of the kernels whose
    name holds any of ``key`` where it is a tuple, by kernel name from the
    profiler, over a few calls."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    keys = (key,) if isinstance(key, str) else key
    by_name = {name: v for name, v in device_time_by_name(prof).items()
               if any(k in name for k in keys)}
    total = sum(us for us, _ in by_name.values())
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"{tag}   {us / n / 1e3:.4f} ms a launch ({100 * us / total:.1f}%)"
              f" x{n // calls} a call: {name[:80]}", flush=True)


# K4-bwd's kernels by route (csrc/ssd_scan_bwd.cu): the tensor-core route
# (wgmma in split TF32; P = 64, chunk 64 or 128) runs the state and
# intra-chunk terms as one launch, and dB/dC and the chunk gradients on
# wgmma where N is 64 or 128; every other shape keeps the route of
# mma.sync.
SSD_BWD_TC = ("ssd_bwd_fused_kernel",)
SSD_BWD_MMA = ("ssd_bwd_state_terms_kernel", "ssd_bwd_intra_kernel")


def ssd_bwd_kernels(call, tries=3):
    """The names of K4-bwd's kernels, by the profiler over three calls.  The
    profiler now and then misses the launches queued as it starts, so a
    window that shows fewer than six is taken again."""
    from torch.profiler import ProfilerActivity, profile
    names = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        names = sorted(nm for nm in device_time_by_name(prof) if "ssd_bwd" in nm)
        if len(names) >= 6:
            break
    return names


def ssd_bwd_route(names):
    tc = any(k in nm for nm in names for k in SSD_BWD_TC)
    mma = any(k in nm for nm in names for k in SSD_BWD_MMA)
    if tc == mma:
        fail(f"ssd_scan_bwd: no single route in {names}")
    return "tensor-core (wgmma)" if tc else "mma.sync"


def phase_ssd_scan_bwd():
    """K4-bwd against its plain version (ref.ssd_chunked_bwd_ref, the
    explicit formulas) on the forward kernel's outputs and workspace, at
    mamba2-370m's training shape, mamba2's SMOKE widths with an initial
    state and a final state's gradient (there also against autograd through
    ref.ssd_chunked_ref), and a decay that overflows exp over the upper
    triangle; two calls must give the same bits.  The training case is
    timed beside the plain backward, with each launch's share, and returns
    its record."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator("cuda").manual_seed(SEED + 5)
    # Tolerance, of each gradient's largest magnitude: f32 in and out, the
    # products in split TF32 (as K4's forward) and the sums in other
    # orders; measured up to ~2.3e-5 (dC at the training shape), held to
    # 1e-4, K4's own.
    tol = 1e-4
    names = ("dx", "ddt", "da", "dB", "dC", "dinit")
    # (label, B, S, H, P, N, chunk, dt range, a (None: -U(0.9, 1)), initial
    # state and dfinal, autograd too).  dt 0.70-0.82 with a near -0.95 is
    # the decay at mamba2-370m's init; training drops the final state, so
    # its gradient is zero there.  The first case gives the record;
    # jamba's (N = 16: the fused launch on wgmma, dB/dC and the chunk
    # gradients on mma.sync) is timed too.
    cases = [
        ("mamba2-370m training", *TRAIN, 32, 64, 128, 128, (0.70, 0.82),
         None, False, False),
        ("jamba-v0.1-52b training", *JAMBA_TRAIN, 128, 64, 16, 128,
         (0.1, 0.9), None, False, False),
        # one card's heads on a model axis of 4 ([parallel tp])
        (MAMBA_LOCAL, *TRAIN, 8, 64, 128, 128, (0.70, 0.82), None, False,
         False),
        (JAMBA_LOCAL, *JAMBA_TRAIN, 32, 64, 16, 128, (0.1, 0.9), None,
         False, False),
        ("mamba2 SMOKE widths", 2, 256, 8, 16, 16, 16, (0.1, 0.9), None,
         True, True),
        ("overflowing decay", 2, 512, 4, 64, 128, 128, (0.70, 0.82), -0.95,
         True, False),
    ]
    record = None
    for label, b, s, h, p, n, chunk, (lo, hi), a_val, extra, auto in cases:
        x, dy = (torch.randn((b, s, h, p), generator=gen, device="cuda")
                 for _ in range(2))
        dt = lo + (hi - lo) * torch.rand((b, s, h), generator=gen,
                                         device="cuda")
        a = (-(0.9 + 0.1 * torch.rand((h,), generator=gen, device="cuda"))
             if a_val is None else torch.full((h,), a_val, device="cuda"))
        bm, cm = (torch.randn((b, s, n), generator=gen, device="cuda")
                  for _ in range(2))
        init, dfinal = ((torch.randn((b, h, p, n), generator=gen,
                                     device="cuda") for _ in range(2))
                        if extra else (None, None))
        args = (x, dt, a, bm, cm, chunk, init)
        _, _, work = ss._forward(*args)
        got = ss.ssd_scan_bwd(*args, dy, dfinal, work)
        torch.cuda.synchronize()
        oracles = [("plain", ref.ssd_chunked_bwd_ref(*args, dy, dfinal))]
        if auto:
            leaves = [t.detach().requires_grad_() for t in args[:5] + (init,)]
            yy, ff = ref.ssd_chunked_ref(*leaves[:5], chunk, leaves[5])
            oracles.append(("autograd", torch.autograd.grad(
                (yy * dy).sum() + (ff * dfinal).sum(), leaves)))
        errs, worst = [], 0.0
        for oname, want in oracles:
            for name, g, w in zip(names, got, want):
                if w is None:
                    continue
                scale = float(w.abs().max())
                err = float((g - w).abs().max())
                if oname == "plain":
                    worst = max(worst, err)
                if g.shape != w.shape or not bool(torch.isfinite(g).all()) \
                        or err > tol * scale:
                    fail(f"ssd_scan_bwd {label}: {name} against the {oname} "
                         f"version: max abs err {err:.3g} > {tol} x "
                         f"{scale:.3g}")
                errs.append(f"{name} {err / scale:.2e}")
            errs[-1] += f" ({oname})"
        del oracles
        again = ss.ssd_scan_bwd(*args, dy, dfinal, work)
        same = all(torch.equal(g, g2) for g, g2 in zip(got, again)
                    if g is not None)
        route = ssd_bwd_route(ssd_bwd_kernels(
            lambda: ss.ssd_scan_bwd(*args, dy, dfinal, work)))
        print(f"[K4 bwd] {label} (B,S,H,P,N)=({b},{s},{h},{p},{n}) chunk "
              f"{chunk}{' with initial state and dfinal' if extra else ''}: "
              f"route {route}; max_abs_err / |max| {', '.join(errs)} (tol "
              f"{tol}); two calls bit-identical: {same}", flush=True)
        if not same:
            fail(f"ssd_scan_bwd {label}: two calls differ")
        if p == 64 and chunk in (64, 128) and not route.startswith("tensor"):
            fail(f"ssd_scan_bwd {label}: took the route of mma.sync")
        if record is not None and label not in K4_TIMED:
            continue
        del got, again
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ss.ssd_scan_bwd(*args, dy, dfinal, work)
        torch.cuda.synchronize()
        extra_mib = (torch.cuda.max_memory_allocated() - before) / 2**20
        ms = device_ms("K4-bwd kernel", lambda: ss.ssd_scan_bwd(
            *args, dy, dfinal, work), iters=20)
        plain_ms = device_ms("K4-bwd plain", lambda: ref.ssd_chunked_bwd_ref(
            *args, dy, dfinal), iters=3)
        flops, nbytes = ssd_bwd_flops_bytes(b, s, h, p, n, chunk,
                                            init is not None,
                                            dfinal is not None)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = 3 * flops / TF32_FLOPS * 1e3    # split TF32, as K4
        case = dict(
            name="ssd_scan_bwd", route="cuda",
            source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            replaces="src/repro/models/ssm.py:72",
            max_abs_err=worst, ms=ms, plain_ms=plain_ms,
            bound_ms=max(byte_ms, op_ms),
            bound_by="bytes" if byte_ms >= op_ms else "operations",
            library_ms=None)
        record = record or case
        print(f"[K4 bwd] {label}: one call takes {extra_mib:.1f} MiB of "
              f"device memory at its peak (the gradients and the scratch); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, no library "
              f"call (no PyTorch call computes the SSD scan's gradient); "
              f"{nbytes} bytes, {flops} flops -> bound "
              f"{case['bound_ms']:.6f} ms ({case['bound_by']}: 3 x the "
              f"flops at {TF32_FLOPS / 1e12:.0f} TFLOP/s TF32, the bytes "
              f"{byte_ms:.6f} ms at {HBM_BYTES_PER_S / 1e12} TB/s); kernel "
              f"at {flops / ms / 1e9:.2f} TFLOP/s of that work, "
              f"{ms / case['bound_ms']:.2f}x its bound", flush=True)
        ssd_launch_times(lambda: ss.ssd_scan_bwd(*args, dy, dfinal, work),
                         key="ssd_bwd", tag="[K4 bwd]")
    return record


SSD_FUSED_SHAPE = (8, 4096)     # mamba2-370m.train's rows a step
SSD_FUSED_KERNELS = ("conv_silu", "dt_softplus", "gated_rmsnorm",
                     "column_sum")
# a value the kernel rounds once to bf16: half a bf16 ulp of itself, and
# f32 sums' share of the output's largest magnitude
BF16_HALF_ULP, F32_SLACK = 2.0 ** -8, 1e-5
# a value the kernel keeps in f32: relative to the f64 value's norm
F32_REL = 1e-4


def _fused_err(got, exact, rounded):
    """(worst distance, its limit, elements over the limit): elementwise
    against half a bf16 ulp plus F32_SLACK of the largest |exact| where
    ``rounded``, else the norm of the difference relative to the norm."""
    got, exact = got.double(), exact.double()
    diff = (got - exact).abs()
    if rounded:
        over = diff - (BF16_HALF_ULP * exact.abs()
                       + F32_SLACK * float(exact.abs().max()))
        return float(diff.max()), float(exact.abs().max()), \
            int((over > 0).sum())
    rel = float(diff.norm() / exact.norm())
    return rel, F32_REL, int(rel > F32_REL)


def phase_ssd_fused():
    """The Mamba-2 layer's fused kernels (``ssd_fused``: the conv and dt's
    forward, the gated norm's forward and backward, the conv and dt's
    backward) against their plain versions on the card at
    mamba2-370m.train's shape (8 x 4096 rows, bf16, 32 heads of 64, state
    128), both against an f64 evaluation of the same function from the
    same inputs (the conv's weights rounded to bf16 as both versions round
    them).  Tolerance: the kernels compute in f32 and round once on the
    store, so a value stored in bf16 (the conv's output, the gated norm's
    output, dz, d xBC, d dt) must lie within half a bf16 ulp of the f64
    value (2^-8 of it) plus 1e-5 of the output's largest magnitude (f32
    sums and cancellation), at every element; a value kept in f32 (dy,
    dt's softplus, 1/rms, the parameters' gradients) within 1e-4 of the
    f64 value's norm.  The plain version rounds each product, partial sum
    and the gate to bf16, so it may miss those limits: its distances are
    printed beside.  Two calls give the same bits.  Then each kernel's
    time, its least bytes at 3.35 TB/s and the plain version's time, each
    of its launches' device time by the profiler, and
    the whole stretch forward and backward (``ssd_mixer``, with K4 and
    K4-bwd) beside its plain composite around the same K4 and K4-bwd
    (``ssd_mixer_ref``).  Returns the kernels' record."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import ssd_fused as sf
    b, s = SSD_FUSED_SHAPE
    h, p, n, chunk = 32, 64, 128, 128
    w = sf.Widths(h, p, n, chunk)
    di, c = h * p, h * p + 2 * n
    gen = torch.Generator("cuda").manual_seed(SEED + 7)
    bf16 = torch.bfloat16

    def rand(*shape, scale=1.0, shift=0.0):
        return shift + scale * torch.randn(shape, generator=gen,
                                           device="cuda")

    proj = rand(b, s, di + c + h).to(bf16)
    conv_w = rand(4, c, scale=0.5)
    dt_bias = -4 + 2 * torch.rand((h,), generator=gen, device="cuda")
    a_log = torch.log(1 + 15 * torch.rand((h,), generator=gen,
                                          device="cuda"))
    d_skip, gamma = rand(h, scale=0.1, shift=1), rand(di, scale=0.1, shift=1)
    y, dx_scan = rand(b, s, h, p), rand(b, s, h, p)
    dy_in = rand(b, s, h, p)
    dbm, dcm, ddt, da = rand(b, s, n), rand(b, s, n), rand(b, s, h), rand(h)
    dout = rand(b, s, di).to(bf16)
    dproj = torch.empty_like(proj)
    xbc, dt_raw, z = (proj[..., di:di + c], proj[..., di + c:],
                      proj[..., :di])
    f64 = torch.float64

    def exact_conv(xbc, wk, dt, bias, alog):
        k = wk.shape[0]
        pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
        u = sum(pad[:, i:i + s, :] * wk[i] for i in range(k))
        out = u * torch.sigmoid(u)
        return (out[..., :di].reshape(b, s, h, p), out[..., di:di + n],
                out[..., di + n:], torch.nn.functional.softplus(dt + bias),
                -torch.exp(alog))

    def exact_gate(y, x, z, d, gm):
        g = (y + d[None, None, :, None] * x).reshape(b, s, di) \
            * (z * torch.sigmoid(z))
        rstd = torch.rsqrt((g * g).mean(-1, keepdim=True) + sf.EPS)
        return g * rstd * gm, rstd[..., 0]

    rows, names = [], []

    def held(kernel_name, what, got, exact, plain, rounded):
        err, lim, over = _fused_err(got, exact, rounded)
        perr, _, pover = _fused_err(plain, exact, rounded)
        kind = (f"max |err| {err:.3g} (|max| {lim:.3g}), {over} over "
                f"half a bf16 ulp + {F32_SLACK:g}|max|" if rounded else
                f"rel {err:.3g} (limit {lim:g})")
        pkind = (f"max |err| {perr:.3g}, {pover} over" if rounded
                 else f"rel {perr:.3g}")
        rows.append(f"[ssd fused] {kernel_name} {what}: kernel {kind}; "
                    f"plain {pkind}")
        print(rows[-1], flush=True)
        if over or not bool(torch.isfinite(got).all()):
            names.append(f"{kernel_name} {what}")

    def same_bits(kernel_name, call):
        first = [t.clone() for t in call()]
        again = call()
        ok = all(torch.equal(a, b_) for a, b_ in zip(first, again))
        print(f"[ssd fused] {kernel_name}: two calls bit-identical: {ok}",
              flush=True)
        if not ok:
            names.append(f"{kernel_name} repeat")

    # conv and dt, forward
    fwd = sf.conv_fwd(proj, conv_w, dt_bias, a_log, w)
    x, bm, cm, dt_soft, a = fwd
    plain = (*sf.conv_fwd_ref(xbc, conv_w, di, n),
             *sf.dt_fwd_ref(dt_raw, dt_bias, a_log))
    wk = conv_w.to(bf16).to(f64)
    exact = exact_conv(xbc.to(f64), wk, dt_raw.to(f64), dt_bias.to(f64),
                       a_log.to(f64))
    for what, got, pl, ex, rounded in zip(
            ("x", "B", "C", "dt softplus", "a"), fwd, plain, exact,
            (True, True, True, False, False)):
        held("conv fwd", what, got, ex, pl.reshape(got.shape), rounded)
    same_bits("conv fwd", lambda: sf.conv_fwd(proj, conv_w, dt_bias, a_log,
                                              w))
    del plain, exact

    # gated norm, forward and backward
    out, rstd = sf.gate_fwd(y, x, proj, d_skip, gamma)
    pout, prstd = sf.gate_fwd_ref(y, x, z, d_skip, gamma)
    leaves64 = [t.to(f64).requires_grad_() for t in (y, z, d_skip, gamma)]
    eout, erstd = exact_gate(leaves64[0], x.to(f64), leaves64[1],
                             leaves64[2], leaves64[3])
    held("gate fwd", "out", out, eout.detach(), pout, True)
    held("gate fwd", "1/rms", rstd, erstd.detach(), prstd, False)
    same_bits("gate fwd", lambda: sf.gate_fwd(y, x, proj, d_skip, gamma))
    grads = sf.gate_bwd(dout, y, x, proj, d_skip, gamma, rstd, dproj)
    dz = dproj[..., :di].clone()
    pdy, pdz, pdd, pdg = sf.gate_bwd_ref(dout, y, x, z, d_skip, gamma)
    edy, edz, edd, edg = torch.autograd.grad(eout, leaves64, dout.to(f64))
    for what, got, pl, ex, rounded in (
            ("dy", grads[0], pdy, edy, False), ("dz", dz, pdz, edz, True),
            ("d d_skip", grads[1], pdd, edd, False),
            ("d out_norm", grads[2], pdg, edg, False)):
        held("gate bwd", what, got, ex, pl, rounded)
    same_bits("gate bwd", lambda: (*sf.gate_bwd(
        dout, y, x, proj, d_skip, gamma, rstd, dproj), dproj[..., :di]))
    del leaves64, eout, erstd, edy, edz, pdy, pdz

    # conv and dt, backward
    grads = sf.conv_bwd(proj, conv_w, dx_scan, dy_in, d_skip, dbm, dcm, ddt,
                        dt_bias, da, a, a_log, dproj, w)
    dxbc, ddt_col = dproj[..., di:di + c].clone(), dproj[..., di + c:].clone()
    pdxbc, pdw = sf.conv_bwd_ref(xbc, conv_w, dx_scan, dy_in, d_skip, dbm,
                                 dcm)
    pddt, pdb, pda = sf.dt_bwd_ref(ddt, da, dt_raw, dt_bias, a_log)
    leaves64 = [t.to(f64).requires_grad_() for t in (xbc, dt_raw, dt_bias,
                                                       a_log)]
    wk64 = wk.clone().requires_grad_()
    ex = exact_conv(leaves64[0], wk64, *leaves64[1:])
    gx = (dx_scan.to(f64) + d_skip.to(f64)[None, None, :, None]
          * dy_in.to(f64))
    edxbc, edw, eddt, edb, eda = torch.autograd.grad(
        ex, [leaves64[0], wk64, *leaves64[1:]],
        [gx, dbm.to(f64), dcm.to(f64), ddt.to(f64), da.to(f64)])
    for what, got, pl, exv, rounded in (
            ("d xBC", dxbc, pdxbc, edxbc, True),
            ("d dt", ddt_col, pddt, eddt, True),
            ("d conv_w", grads[0], pdw, edw, False),
            ("d dt_bias", grads[1], pdb, edb, False),
            ("d a_log", grads[2], pda, eda, False)):
        held("conv bwd", what, got, exv, pl, rounded)
    same_bits("conv bwd", lambda: (*sf.conv_bwd(
        proj, conv_w, dx_scan, dy_in, d_skip, dbm, dcm, ddt, dt_bias, da, a,
        a_log, dproj, w), dproj[..., di:]))
    del leaves64, ex, edxbc, edw, eddt, pdxbc, pddt
    torch.cuda.empty_cache()
    if names:
        fail(f"ssd fused kernels off their f64 values: {names}")

    # times: each kernel, its byte bound and its plain version
    def plain_grad(fn, inputs, wanted, grads_out):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() if i in wanted else t
                      for i, t in enumerate(inputs)]
            outs = fn(*leaves)
        return lambda: torch.autograd.grad(
            outs, [leaves[i] for i in wanted], grads_out, retain_graph=True)

    conv_plain = lambda: (sf.conv_fwd_ref(xbc, conv_w, di, n),  # noqa: E731
                          sf.dt_fwd_ref(dt_raw, dt_bias, a_log))
    cases = [
        ("conv fwd", lambda: sf.conv_fwd(proj, conv_w, dt_bias, a_log, w),
         conv_plain,
         cost.ssd_conv_flops_bytes(b * s, c, h, 2)),
        ("gate fwd", lambda: sf.gate_fwd(y, x, proj, d_skip, gamma),
         lambda: sf.gate_fwd_ref(y, x, z, d_skip, gamma),
         cost.ssd_gate_flops_bytes(b * s, di, h, 2)),
        ("gate bwd", lambda: sf.gate_bwd(dout, y, x, proj, d_skip, gamma,
                                         rstd, dproj),
         plain_grad(lambda *t: sf.gate_fwd_ref(*t)[:1],
                    (y, x, z, d_skip, gamma), (0, 2, 3, 4), (dout,)),
         cost.ssd_gate_bwd_flops_bytes(b * s, di, h, 2)),
        ("conv bwd", lambda: sf.conv_bwd(
            proj, conv_w, dx_scan, dy_in, d_skip, dbm, dcm, ddt, dt_bias, da,
            a, a_log, dproj, w),
         lambda: (sf.conv_bwd_ref(xbc, conv_w, dx_scan, dy_in, d_skip, dbm,
                                  dcm),
                  sf.dt_bwd_ref(ddt, da, dt_raw, dt_bias, a_log)),
         cost.ssd_conv_bwd_flops_bytes(b * s, c, di, h, 2)),
    ]
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for label, kernel, plain_fn, (flops, nbytes) in cases:
        ms = device_ms(f"ssd fused {label}", kernel, iters=20)
        plain_ms = device_ms(f"ssd fused {label} plain", plain_fn, iters=5)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound)):
            total[k] += v
        print(f"[ssd fused] {label}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, no library call; {nbytes} bytes, {flops} "
              f"flops -> bound {bound:.6f} ms (bytes at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s; the flops take "
              f"{flops / F32_FLOPS * 1e3:.6f} ms at {F32_FLOPS / 1e12:.0f} "
              f"TFLOP/s f32), {ms / bound:.2f}x its bound, "
              f"{nbytes / ms / 1e6:.0f} GB/s", flush=True)
        ssd_launch_times(kernel, key=SSD_FUSED_KERNELS,
                         tag=f"[ssd fused] {label}:")

    # the whole stretch, forward and backward, around K4 and K4-bwd
    leaves = [t.detach().requires_grad_() for t in (
        proj, conv_w, dt_bias, a_log, d_skip, gamma)]

    def stretch(fn):
        def run():
            out, _ = fn(*leaves, None, w)
            return torch.autograd.grad(out, leaves, dout)
        return run

    fused_ms = device_ms("ssd fused stretch", stretch(sf.ssd_mixer), iters=5)
    plain_ms = device_ms("ssd plain stretch", stretch(sf.ssd_mixer_ref),
                         iters=3)
    print(f"[ssd fused] the stretch between the projections, forward and "
          f"backward, with K4 and K4-bwd: fused {fused_ms:.3f} ms, plain "
          f"composite {plain_ms:.3f} ms; the four kernels {total['ms']:.4f} "
          f"ms against their plain versions' {total['plain_ms']:.4f} ms and "
          f"their byte bound {total['bound_ms']:.4f} ms", flush=True)
    return dict(name="ssd_fused", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_fused.cu",
                replaces=None, ms=total["ms"], plain_ms=total["plain_ms"],
                bound_ms=total["bound_ms"], bound_by="bytes",
                library_ms=None, stretch_ms=fused_ms,
                stretch_plain_ms=plain_ms)


def reset_counts():
    from repro_torch.kernels import (flash_attention, gc_compact,
                                     paged_attention, ssd_fused, ssd_scan)
    flash_attention.launches = 0
    flash_attention.bwd_launches = 0
    paged_attention.launches = 0
    gc_compact.launches = 0
    ssd_scan.launches = 0
    ssd_scan.bwd_launches = 0
    ssd_fused.launches = 0
    ssd_fused.bwd_launches = 0
    ssd_fused.gate_launches = 0
    ssd_fused.gate_bwd_launches = 0


def full_params(cfg):
    from repro_torch.models import get_model
    gen = torch.Generator("cuda").manual_seed(SEED)
    return get_model(cfg).init(cfg, gen, "cuda")


def phase_prefill_f32_check(params):
    """K3 inside the model: the chunked forward (K3, f32) against the naive
    one (plain PyTorch, f32) at full olmo-1b width; then dense-cache decode
    against the chunked forward.  Both at 2e-3: f32 throughout, sums in
    different orders, through 16 layers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.train import synthetic_batch
    tol = 2e-3
    base = dataclasses.replace(get_config("olmo-1b"),
                               compute_dtype=torch.float32)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_batch(base, 1, 1, 1024).items()}
    logits = {}
    with torch.no_grad():
        for impl in ["naive", "chunked"]:
            fa.launches = 0
            logits[impl] = transformer.forward(
                params, batch, dataclasses.replace(base, attn_impl=impl))
            torch.cuda.synchronize()
            if fa.launches != (base.n_layers if impl == "chunked" else 0):
                fail(f"prefill f32 check: {fa.launches} flash_attention "
                     f"launches on the {impl} path")
    diff = (logits["chunked"] - logits["naive"]).abs()
    err = float(diff.max())
    bad = bool((diff > tol + tol * logits["naive"].abs()).any())
    print(f"[prefill f32 check] olmo-1b batch 1 seq 1024 f32: chunked (K3, "
          f"{base.n_layers} launches) vs naive logits max_abs_err={err:.3g} "
          f"(tol {tol}, |logits| <= {float(logits['naive'].abs().max()):.3g})",
          flush=True)
    if bad or not bool(torch.isfinite(logits["chunked"]).all()):
        fail(f"prefill f32 check: chunked and naive differ by {err:.3g}")

    phase_decode_transformer(dataclasses.replace(base, attn_impl="chunked"),
                             params)


def train_setup(cfg, b, s, lr=1e-3, seed=SEED, mesh=None):
    """Params from seed, AdamW state and the train step (on ``mesh`` where
    given), all on the card."""
    from repro_torch.models import get_model
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   build_train_step, init_state)
    tc = TrainConfig(adamw=AdamWConfig(lr=lr))
    params = get_model(cfg).init(cfg, torch.Generator("cuda").manual_seed(seed),
                                 "cuda")
    step, _ = build_train_step(cfg, b, s, tc, mesh=mesh)
    return params, init_state(params, tc.adamw), step


def phase_train(cfg, kernels, parts, keep, labels=None, repeat=True,
                shape=TRAIN, mesh=None, tag=None, profile=True, stats=None):
    """The training path at full width: TRAIN_STEPS steps of
    build_train_step (batch and seq ``shape``, AdamW lr 1e-3, params from
    SEED, synthetic_batch steps 0-4; on ``mesh`` where given), each step's
    loss, grad norm, time by CUDA events and launches, then the same step
    taken twice from one state (check_step_repeats; check_run_repeats
    where ``repeat`` is "replay": a state that fits the card once, not
    twice; none where it is false) and, where ``profile``, one profiled
    step.  ``kernels`` is [(name, its count now, its launches a step)];
    ``parts``, ``keep`` and ``labels`` go to profile_train_step.  Returns
    each kernel's launches over the run; ``stats``, where given, gets the
    mean step time over steps 2-4 (``ms``), each step's (``times``), the
    peak device memory in GiB (``peak_gib``), the profiled step's kernels
    (``by_name``)."""
    from repro_torch.train import synthetic_batch
    b, s = shape
    tag = tag or f"[train {cfg.name}]"
    params, opt, step = train_setup(cfg, b, s, mesh=mesh)
    batches = [synthetic_batch(cfg, i, b, s) for i in range(TRAIN_STEPS + 1)]
    want = [per_step for *_, per_step in kernels]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # The path: counts set to 0 just before, read just after.
    reset_counts()
    times = []
    for i in range(TRAIN_STEPS):
        before = [count() for _, count, _ in kernels]
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.perf_counter()
        e0.record()
        params, opt, metrics = step(params, opt, batches[i])
        e1.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        times.append(e0.elapsed_time(e1))
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        got = [count() - n for (_, count, _), n in zip(kernels, before)]
        print(f"{tag} step {i}: loss={loss:.6f} grad_norm={norm:.6f}; "
              f"{times[-1]:.3f} ms by CUDA events ({wall:.3f} ms host "
              f"wall); launches " + " ".join(
                  f"{name}={n}" for (name, _, _), n in zip(kernels, got)),
              flush=True)
        if not (np.isfinite(loss) and np.isfinite(norm)):
            fail(f"train {cfg.name}: step {i} loss {loss} grad_norm {norm}")
        if got != want:
            fail(f"train {cfg.name}: step {i} launched {got} for {want} "
                 f"({cfg.n_layers} layers under remat)")
    totals = [count() for _, count, _ in kernels]
    ms = sum(times[1:]) / (len(times) - 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag} batch {b} seq {s}, bf16 compute, f32 params, remat "
          f"{cfg.remat}: {TRAIN_STEPS} steps, {ms:.3f} ms a step over steps "
          f"2-{TRAIN_STEPS}; peak device memory {peak:.2f} GiB; launches "
          + " ".join(f"{name}={n}" for (name, _, _), n in zip(kernels,
                                                                totals)),
          flush=True)
    if stats is not None:
        stats.update(ms=ms, peak_gib=peak, times=times)
    if repeat == "replay":
        state = [params, opt]
        del params, opt
        params, opt = check_run_repeats(tag, cfg, shape, step, state,
                                        batches)
    elif repeat:
        check_step_repeats(tag, step, params, opt, batches[TRAIN_STEPS])
    if profile:
        by_name = profile_train_step(step, params, opt, batches[TRAIN_STEPS],
                                     f"{cfg.name} batch {b} seq {s}", parts,
                                     keep, labels)
        if stats is not None:
            stats["by_name"] = by_name
    return totals


def check_step_repeats(tag, step, params, opt, batch):
    """One step taken twice, from the state and from a clone of it made
    before the step, must give the same bits in every leaf of params, mu,
    nu and count and in the loss and grad norm: a resumed run replays an
    uninterrupted one only if every step does.  Runs after the timed steps
    and the peak-memory reading.  Prints the first leaf that differs, and
    the check's wall time (clone, two steps, compare)."""
    from repro_torch.checkpoint import named_leaves
    from repro_torch.train.optimizer import clone_tree
    t = time.perf_counter()
    twin_params, twin_opt = clone_tree(params), clone_tree(opt)
    runs = []
    for p, o in ((params, opt), (twin_params, twin_opt)):
        p, o, m = step(p, o, batch)
        runs.append(named_leaves({"params": p, "opt": o, "metrics": m}))
    torch.cuda.synchronize()
    differ = [(name, float((x.double() - y.double()).abs().max()),
               int((x != y).sum()))
              for (name, x), (_, y) in zip(*runs) if not torch.equal(x, y)]
    print(f"{tag} one step twice from the same state: {len(runs[0])} leaves "
          f"(params, mu, nu, count, loss, grad norm), bit-identical: "
          f"{not differ}" + (f"; first that differs: {differ[0][0]} (max "
                             f"|diff| {differ[0][1]:.3g} at {differ[0][2]} "
                             f"elements), {len(differ)} leaves differ"
                             if differ else "")
          + f"; check wall {time.perf_counter() - t:.3f} s", flush=True)
    del twin_params, twin_opt, runs
    torch.cuda.empty_cache()
    if differ:
        fail(f"train: one step from the same state differs in "
             f"{[d[0] for d in differ]}")


def leaf_digest(x):
    """Two 64-bit sums of a tensor's bit patterns, the second weighted by
    position: a fingerprint of its bits that a changed element moves."""
    ints = {4: torch.int32, 2: torch.int16, 1: torch.int8}[x.element_size()]
    bits = x.contiguous().view(ints).reshape(-1).to(torch.int64)
    weight = torch.arange(bits.numel(), device=x.device) % 65521 + 1
    return int(bits.sum()), int((bits * weight).sum())


def state_digests(params, opt, metrics):
    from repro_torch.checkpoint import named_leaves
    return [(name, leaf_digest(x)) for name, x in
            named_leaves({"params": params, "opt": opt, "metrics": metrics})]


def check_run_repeats(tag, cfg, shape, step_fn, state, batches):
    """For a state the card holds once but not twice: one more step from
    the timed run's state, then the whole run again from the seed (init,
    the same TRAIN_STEPS + 1 batches); both must end on the same bits in
    every leaf of params, mu, nu and count and in the loss and grad norm,
    compared by fingerprints (leaf_digest).  ``state`` is the list
    [params, opt], emptied here so that the first run's state is freed;
    returns the state the second run ends on."""
    t = time.perf_counter()
    params, opt, metrics = step_fn(*state, batches[TRAIN_STEPS])
    first = state_digests(params, opt, metrics)
    state.clear()
    del params, opt, metrics
    torch.cuda.empty_cache()
    params, opt, step_fn = train_setup(cfg, *shape)
    for batch in batches:
        params, opt, metrics = step_fn(params, opt, batch)
    second = state_digests(params, opt, metrics)
    differ = [name for (name, x), (_, y) in zip(first, second) if x != y]
    print(f"{tag} {TRAIN_STEPS + 1} steps from the seed, taken twice, end "
          f"on the same bits (fingerprints of {len(first)} leaves: params, "
          f"mu, nu, count, loss, grad norm): {not differ}"
          + (f"; {len(differ)} differ, the first {differ[0]}" if differ
             else "") + f"; check wall {time.perf_counter() - t:.3f} s",
          flush=True)
    if differ:
        fail(f"train: the run repeated from the seed differs in {differ}")
    return params, opt


# (substrings of a kernel's name, part), first match wins
PRODUCT_PART = (("nvjet", "gemm", "cutlass", "xmma"), "matrix products (cuBLAS)")
TRAIN_PARTS = ((("flash_attention_bwd",), "K3-bwd (flash_attention_bwd)"),
               (("flash_attention",), "K3 forward + recompute"),
               PRODUCT_PART)
TRAIN_PARTS_SSM = ((("ssd_bwd",), "K4-bwd (ssd_scan_bwd)"),
                   (("ssd_scan",), "K4 forward + recompute"),
                   (("conv_silu_bwd", "gated_rmsnorm_bwd", "dt_softplus_bwd",
                     "column_sum"), "fused conv, gate, norm: backward"),
                   (("conv_silu", "gated_rmsnorm", "dt_softplus"),
                    "fused conv, gate, norm: forward + recompute"),
                   PRODUCT_PART)


REST = "elementwise, casts, reductions, optimizer"
# the training phases' labels of the program's parts (repro_torch.ranges)
TRAIN_LABELS = {"embed": "embedding", "layer": "layer: residual adds",
                "attention": "attention (norm, projections, RoPE)",
                "mamba": "Mamba-2 (norm, projections, conv, gate, casts)",
                "ffn": "FFN: norm, weight casts, activation",
                "unembed": "unembedding: final norm, casts",
                "loss": "cross-entropy", "grad_norm": "gradient norm",
                "adamw": "AdamW"}


def program_range(e):
    """The innermost of the program's profiler ranges
    (``repro_torch.ranges``) around a profiled op, or None: a gradient op
    lies in its part's ``.bwd`` range, a remat recompute in ``.remat``."""
    from repro_torch import ranges
    while e is not None and e.name not in ranges.NAMES:
        e = e.cpu_parent
    return None if e is None else e.name


def device_parts(prof, parts, labels, fallback=(PRODUCT_PART,)):
    """{part: device ms} of one profiled run.  A kernel goes to the first
    of ``parts`` [((name substrings), part)] that its name matches; else,
    where ``labels`` {range's part: part} names one, to the part of the
    program range that launched it (``program_range``), in any pass; else
    to the first of ``fallback`` that its name matches, else to REST."""
    from torch.autograd import DeviceType

    from repro_torch import ranges
    totals = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        for kernel in e.kernels:
            if kernel.name in ranges.NAMES:
                continue
            part = next((p for keys, p in parts
                         if any(key in kernel.name for key in keys)), None)
            if part is None and labels:
                up = program_range(e)
                part = labels.get(up and ranges.split(up)[0])
            if part is None:
                part = next((p for keys, p in fallback
                             if any(key in kernel.name for key in keys)),
                            REST)
            totals[part] = totals.get(part, 0.0) + kernel.duration / 1e3
    return totals


def device_passes(prof):
    """{pass: device ms} of one profiled run: each kernel by the pass of
    the program range that launched it (forward, remat, bwd), or "no
    range"."""
    from torch.autograd import DeviceType

    from repro_torch import ranges
    totals = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        up = program_range(e)
        kind = ranges.split(up)[1] if up else "no range"
        for kernel in e.kernels:
            if kernel.name not in ranges.NAMES:
                totals[kind] = totals.get(kind, 0.0) + kernel.duration / 1e3
    return totals


def profile_train_step(step, params, opt, batch, label, parts, keep,
                       labels=None):
    """Where one full-width training step spends device time
    (device_parts): by kernel name (the backward kernel, the forward
    kernel, the matrix products), by the model's profiler ranges where
    ``labels`` names them, and the rest (elementwise passes, casts,
    reductions, the optimizer's update); then the AdamW update alone, by
    CUDA events.  Returns the profiled step's {kernel: (device us,
    count)}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import AdamWConfig, apply_updates
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = device_time_by_name(prof)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    totals = device_parts(prof, parts, labels or {})
    unlinked = busy_ms - sum(totals.values())
    if abs(unlinked) > 1e-3:
        totals["kernels linked to no op"] = unlinked
    print(f"[profile] train step {label}: wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms ({100 * (1 - busy_ms / wall_ms):.1f}% "
          f"idle) in {sum(n for _, n in by_name.values())} device "
          "activities", flush=True)
    for part, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  {part}")
    print("[profile]   by pass (the program's ranges): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in sorted(device_passes(prof).items(),
                                             key=lambda kv: -kv[1])),
          flush=True)
    print_ranked(by_name, keep)
    grads = tree_unflatten(params, [torch.zeros_like(p)
                                    for p in tree_leaves(params)])
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    apply_updates(params, grads, opt, AdamWConfig(lr=1e-3))
    e1.record()
    torch.cuda.synchronize()
    print(f"[profile]   of which the AdamW update alone: "
          f"{e0.elapsed_time(e1):.3f} ms by CUDA events", flush=True)
    return by_name


def phase_train_f32_check():
    """One f32 step's loss and gradients, chunked (K3 f32 forward and
    K3-bwd f32) against naive (einsum and autograd), at full olmo-1b width
    with the depth cut to 2 layers (time and memory), batch 1, seq 1024.
    The loss is held to 1e-5 relative.  The gradients are held to the
    spread of f32 itself: the random init gives scores with a std in the
    hundreds (ROADMAP F7; the 2-layer cut raises the init's std by √8), so
    the softmax is nearly one-hot, dS = P (dP − Δ) cancels, and two f32
    computations of the same naive path, on the card and on the host CPU,
    already differ by ‖Δg‖/‖g‖ of several 1e-2 at wq and wk.  Each leaf of
    the chunked path must lie no farther from the card's naive gradient
    than the host's naive gradient does (and within 1e-4 where that spread
    is smaller)."""
    from repro_torch.checkpoint import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.train import synthetic_batch
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    base = dataclasses.replace(get_config("olmo-1b"), n_layers=2,
                               compute_dtype=torch.float32)
    params = transformer.init(base, torch.Generator("cuda").manual_seed(SEED),
                              "cuda")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_batch(base, 2, 1, 1024).items()}

    def loss_and_grads(params, batch, impl):
        cfg = dataclasses.replace(base, attn_impl=impl)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = transformer.loss_fn(tree_unflatten(params, leaves), batch,
                                   cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return float(loss.detach()), [g.cpu() for g in grads]

    res = {}
    for impl in ["naive", "chunked"]:
        fa.launches = fa.bwd_launches = 0
        res[impl] = loss_and_grads(params, batch, impl)
        torch.cuda.synchronize()
        want = ((2 * base.n_layers, base.n_layers) if impl == "chunked"
                else (0, 0))
        if (fa.launches, fa.bwd_launches) != want:
            fail(f"train f32 check: {impl} launched K3 {fa.launches} and "
                 f"K3-bwd {fa.bwd_launches} times")
    t = time.perf_counter()
    host = loss_and_grads(tree_unflatten(params, [p.cpu() for p in
                                              tree_leaves(params)]),
                          {k: v.cpu() for k, v in batch.items()}, "naive")
    host_s = time.perf_counter() - t
    (l0, g0), (l1, g1), (_, gh) = res["naive"], res["chunked"], host
    loss_rel = abs(l1 - l0) / abs(l0)
    rows, bad = [], []
    for (name, _), a, c, h in zip(named_leaves(params), g0, g1, gh):
        norm = float(a.norm())
        if norm == 0.0:                 # olmo's norm gains: not read
            if c.any():
                bad.append(name)
            continue
        rel, spread = float((c - a).norm()) / norm, float((h - a).norm()) / norm
        rows.append(f"{name} {rel:.3g} (host {spread:.3g})")
        if rel > max(spread, 1e-4):
            bad.append(name)
    print(f"[train f32 check] olmo-1b full width, 2 layers, batch 1 seq "
          f"1024 f32, remat {base.remat}: loss naive {l0:.7f} chunked "
          f"{l1:.7f} (rel {loss_rel:.3g}, tol 1e-5); ‖Δg‖/‖g‖ of chunked "
          f"against naive on the card (host naive against it, {host_s:.1f} "
          "s on the CPU): " + ", ".join(rows), flush=True)
    if not np.isfinite(l1) or loss_rel > 1e-5 or bad:
        fail(f"train f32 check: chunked and naive gradients differ at "
             f"{bad or 'the loss'}")


def phase_train_mamba_f32_check():
    """One f32 step's loss and gradients at full mamba2-370m width with the
    depth cut to 2 layers (time and memory), batch 1, seq 1024 (8 chunks),
    remat "full": the kernel path (K4 forward and recompute, K4-bwd)
    against autograd through the plain chunked scan (``ops.ssd`` set to
    ref.ssd_chunked_ref for that run) on the card.  The loss is held to
    1e-5 relative.  The gradients are held to the spread of f32 itself,
    measured in this run as olmo-1b's are (ROADMAP F7): the same plain path
    on the host CPU against it on the card.  Here every leaf of the plain
    path already moves by ~2e-4 from the card to the host (at 2 layers of
    random init one step's gradient is that sensitive to rounding), and
    the kernel path is one more f32 computation of it, its products in
    split TF32 (2^-21 relative, not f32's 2^-24): the two distances are of
    one size and either may be the larger at a leaf (conv_w 1.82e-4
    against 1.70e-4 in the first run).  So each leaf of the kernel path
    must lie within twice that spread of the card's plain gradient, and
    within 1e-4 where twice the spread is smaller; a wrong gradient is off
    by its own size."""
    from repro_torch.checkpoint import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import ssm
    from repro_torch.train import synthetic_batch
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=2,
                              compute_dtype=torch.float32)
    params = ssm.init(cfg, torch.Generator("cuda").manual_seed(SEED), "cuda")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_batch(cfg, 2, 1, 1024).items()}
    kernel_ssd = ops.ssd

    def loss_and_grads(params, batch, impl):
        ops.ssd = kernel_ssd if impl == "kernel" else ref.ssd_chunked_ref
        try:
            leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
            loss = ssm.loss_fn(tree_unflatten(params, leaves), batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            ops.ssd = kernel_ssd
        return float(loss.detach()), [g.cpu() for g in grads]

    res = {}
    for impl in ["plain", "kernel"]:
        ss.launches = ss.bwd_launches = 0
        res[impl] = loss_and_grads(params, batch, impl)
        torch.cuda.synchronize()
        want = ((2 * cfg.n_layers, cfg.n_layers) if impl == "kernel"
                else (0, 0))
        if (ss.launches, ss.bwd_launches) != want:
            fail(f"train mamba2 f32 check: {impl} launched K4 {ss.launches} "
                 f"and K4-bwd {ss.bwd_launches} times")
    t = time.perf_counter()
    host = loss_and_grads(tree_unflatten(params, [p.cpu() for p in
                                              tree_leaves(params)]),
                          {k: v.cpu() for k, v in batch.items()}, "plain")
    host_s = time.perf_counter() - t
    (l0, g0), (l1, g1), (_, gh) = res["plain"], res["kernel"], host
    loss_rel = abs(l1 - l0) / abs(l0)
    rows, bad = [], []
    for (name, _), a, c, h in zip(named_leaves(params), g0, g1, gh):
        norm = float(a.norm())
        rel, spread = float((c - a).norm()) / norm, float((h - a).norm()) / norm
        rows.append(f"{name} {rel:.3g} (host {spread:.3g})")
        if rel > max(2 * spread, 1e-4):
            bad.append(name)
    print(f"[train mamba2 f32 check] mamba2-370m full width, 2 layers, batch "
          f"1 seq 1024 f32, remat {cfg.remat}: loss plain {l0:.7f} kernel "
          f"{l1:.7f} (rel {loss_rel:.3g}, tol 1e-5); ‖Δg‖/‖g‖ of the kernel "
          f"path against the plain one on the card (host plain against it, "
          f"{host_s:.1f} s on the CPU; held to twice that): "
          + ", ".join(rows), flush=True)
    if not np.isfinite(l1) or loss_rel > 1e-5 or bad:
        fail(f"train mamba2 f32 check: kernel and plain gradients differ at "
             f"{bad or 'the loss'}")


TRAIN_LINE = re.compile(r"step=(\d+) loss=(\d+\.\d{4}) dt=\d+ms( STRAGGLER)?")


def train_driver_lines(argv, label=None):
    """The train driver in this process, on the card: (rc, its lines),
    each printed."""
    from repro_torch.launch import train
    label = label or " ".join(argv)
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    torch.cuda.synchronize()
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        print(f"[train driver {label}] {line}", flush=True)
    print(f"[train driver {label}] rc {rc}, main() wall "
          f"{(time.perf_counter() - t) * 1e3:.3f} ms", flush=True)
    return rc, lines


def run_train_driver(argv):
    """The train driver in this process, on the card; its step lines must
    have the JAX driver's format and finite losses."""
    rc, lines = train_driver_lines(argv)
    steps = [TRAIN_LINE.fullmatch(line) for line in lines[:-1]]
    if rc != 0 or not lines or lines[-1] != "training done" \
            or not all(steps) or not all(np.isfinite(float(m.group(2)))
                                         for m in steps):
        fail(f"train driver {argv}: rc {rc}, unexpected output")


def step_losses(lines):
    """{step: the loss as printed} of a driver's step lines."""
    return {int(m.group(1)): m.group(2)
            for m in map(TRAIN_LINE.fullmatch, lines) if m}


def state_like(cfg, seed):
    """A training state of ``cfg`` on the card to restore into: params
    from another seed, zero moments."""
    from repro_torch.models import get_model
    from repro_torch.train import AdamWConfig, init_state
    params = get_model(cfg).init(cfg, torch.Generator("cuda")
                                 .manual_seed(seed), "cuda")
    return {"params": params, "opt": init_state(params, AdamWConfig())}


def crash_resume(arch):
    """Crash after step 5 of 8 (checkpoints after steps 2 and 5), resume,
    and an uninterrupted run, all through the train driver on the card;
    the final checkpoints (step 7) restored into card tensors must hold
    the same bits, and the resumed losses must be the uninterrupted
    ones."""
    from repro_torch.checkpoint import CheckpointStore, named_leaves
    from repro_torch.configs import get_config
    tag = f"[checkpoint {arch} SMOKE]"
    base = ["--arch", arch, "--smoke", "--steps", "8", "--batch", "2",
            "--seq", "32", "--ckpt-every", "3"]
    with tempfile.TemporaryDirectory(prefix="ckpt_") as root:
        crashed, whole = (os.path.join(root, d) for d in ("crashed", "whole"))
        rc, lines = train_driver_lines(base + ["--ckpt-dir", crashed,
                                               "--fail-at", "5"],
                                       f"{arch} --fail-at 5")
        if rc != 42 or sorted(step_losses(lines)) != list(range(6)):
            fail(f"{tag} the crashed run: rc {rc}, {lines}")
        rc, resumed = train_driver_lines(base + ["--ckpt-dir", crashed,
                                                 "--resume"],
                                         f"{arch} --resume")
        if rc != 0 or resumed[0] != "resumed from step 5" \
                or sorted(step_losses(resumed)) != [6, 7] \
                or resumed[-1] != "training done":
            fail(f"{tag} the resumed run: rc {rc}, {resumed}")
        rc, full = train_driver_lines(base + ["--ckpt-dir", whole],
                                      f"{arch} uninterrupted")
        want = step_losses(full)
        if rc != 0 or sorted(want) != list(range(8)):
            fail(f"{tag} the uninterrupted run: rc {rc}, {full}")
        got = step_losses(lines) | step_losses(resumed)
        if got != want:
            fail(f"{tag} losses {got} against uninterrupted {want}")
        cfg = get_config(arch, smoke=True)
        trees = []
        for i, d in enumerate((crashed, whole)):
            step, tree = CheckpointStore(d, recover=True).restore(
                like=state_like(cfg, SEED + 1 + i))
            if step != 7:
                fail(f"{tag} {d}: latest checkpoint {step}, not 7")
            trees.append(named_leaves(tree))
        differ = [name for (name, x), (_, y) in zip(*trees)
                  if x.device.type != "cuda" or not torch.equal(x, y)]
    print(f"{tag} crashed after step 5 (rc 42), resumed from step 5, losses "
          f"of steps 0-7 equal to the uninterrupted run's; step 7 restored "
          f"into card tensors: {len(trees[0])} leaves, bit-identical to the "
          f"uninterrupted run's: {not differ}", flush=True)
    if differ:
        fail(f"{tag} the resumed run's final state differs in {differ}")


CKPT_LAYERS = 2                # mamba2-370m cut from 48 layers
# One save: the engine's rate falls as the store fills, and three saves of
# this state would outlast the time this script may take
# (tools/ckpt_throughput.py takes more).
CKPT_SAVES = 1


def tree_bytes(tree):
    from repro_torch.checkpoint import named_leaves
    return sum(x.numel() * x.element_size() for _, x in named_leaves(tree))


def phase_checkpoint_throughput(card, saves=CKPT_SAVES):
    """``saves`` saves (keep_last=2), a recovery and a restore into card
    tensors of the full-width mamba2-370m training state (f32 params after
    one step, both AdamW moments, the count), cut to CKPT_LAYERS layers.
    Host time on the card's machine (the store is pure Python; the device
    keeps every file's bytes in host memory too): printed, with the card's
    name and power limit, and the full-width olmo-1b state's save time at
    the measured rate as an extrapolation."""
    from repro_torch.checkpoint import (CheckpointConfig, CheckpointStore,
                                        named_leaves)
    from repro_torch.configs import get_config
    from repro_torch.train import build_train_step, synthetic_batch
    cfg = dataclasses.replace(get_config("mamba2-370m"),
                              n_layers=CKPT_LAYERS)
    b, s = TRAIN
    params, opt, step = train_setup(cfg, b, s)
    params, opt, _ = step(params, opt, synthetic_batch(cfg, 0, b, s))
    torch.cuda.synchronize()
    state = {"params": params, "opt": opt}
    nbytes = tree_bytes(state)
    tag = (f"[checkpoint mamba2-370m full width, {CKPT_LAYERS} of 48 layers "
           f"(cut: depth), {nbytes / 2**30:.3f} GiB]")
    t = time.perf_counter()
    host = [x.cpu().numpy().tobytes() for _, x in named_leaves(state)]
    copy_s = time.perf_counter() - t
    del host
    with tempfile.TemporaryDirectory(prefix="ckpt_") as root:
        st = CheckpointStore(root, CheckpointConfig(keep_last=2))
        save_s = []
        for i in range(saves):
            t = time.perf_counter()
            st.save(i, state, extra={"loss": 0.0})
            save_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        st.db.flush_all()
        flush_s = time.perf_counter() - t
        usage = st.db.space_usage()
        disk = sum(os.path.getsize(os.path.join(root, f))
                   for f in os.listdir(root))
        gc_runs = int(st.db.stats_counters["gc_runs"])
        del st
        t = time.perf_counter()
        st = CheckpointStore(root, CheckpointConfig(keep_last=2),
                             recover=True)
        recover_s = time.perf_counter() - t
        like = state_like(cfg, SEED + 1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got, tree = st.restore(like=like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        differ = [name for (name, x), (_, y) in zip(named_leaves(tree),
                                                    named_leaves(state))
                  if not torch.equal(x, y)]
        del st
    rate = [nbytes / x / 1e6 for x in save_s]
    _, (p_abs, o_abs, _) = build_train_step(get_config("olmo-1b"), 1, 8)
    olmo = tree_bytes({"params": p_abs, "opt": o_abs})
    print(f"{tag} on {card}: saves "
          + ", ".join(f"{x:.3f} s ({r:.1f} MB/s)" for x, r in zip(save_s,
                                                                 rate))
          + f" (of which the state's copy to host bytes alone takes "
          f"{copy_s:.3f} s); flush_all {flush_s:.3f} s; {disk / 1e9:.3f} GB "
          "on disk "
          f"({disk / nbytes:.2f}x the state), global_garbage_ratio "
          f"{usage['global_garbage_ratio']:.4f}, gc_runs {gc_runs} after "
          f"{saves} save(s) with keep_last=2; recovery (open with "
          f"recover=True) {recover_s:.3f} s; restore of step {got} into card "
          f"tensors {restore_s:.3f} s ({nbytes / restore_s / 1e6:.1f} MB/s), "
          f"bit-identical: {not differ}", flush=True)
    print(f"{tag} extrapolation, not measured: the full-width olmo-1b "
          f"training state ({olmo / 2**30:.2f} GiB) would take at least "
          f"{olmo / (max(rate) * 1e6):.0f} s a save at this rate (at "
          "least: the rate falls as the store fills)", flush=True)
    if got != saves - 1 or differ:
        fail(f"{tag} restored step {got}, leaves that differ {differ}")


def run_serve(argv, expect):
    from repro_torch.launch import serve
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    torch.cuda.synchronize()
    line = buf.getvalue().strip()
    print(f"[serve {' '.join(argv)}] {line} (main() wall "
          f"{(time.perf_counter() - t) * 1e3:.3f} ms)", flush=True)
    if rc != 0 or not line.startswith(expect):
        fail(f"serve {argv}: expected '{expect}'")
    return {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)\b(?![./])", line)}


def device_time_by_name(prof):
    """{kernel name: (device us, count)}; a profiler range's own span on the
    device timeline (a user annotation) is not a kernel."""
    from torch.autograd import DeviceType

    from repro_torch import ranges
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in ranges.NAMES \
                and not getattr(e, "is_user_annotation", False):
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.device_time, n + 1)
    return by_name


def print_ranked(by_name, keep):
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for i, (name, (us, n)) in enumerate(ranked):
        if i < 12 or any(k in name for k in keep):
            print(f"[profile]   {us / 1e3:9.3f} ms {n:5d}x {name[:90]}")


PRODUCTS = ("aten::einsum", "aten::matmul")


def product_part(e, vocab):
    """Which of the model's products a top-level einsum or matmul is: the
    FFN uses ``@`` (matmul), attention projections and the unembedding
    ``einsum``, whose inner bmm/mm has the vocabulary as its last dim only
    for the unembedding."""
    if e.name not in PRODUCTS or (e.cpu_parent is not None
                                  and e.cpu_parent.name in PRODUCTS):
        return None
    if e.name == "aten::matmul":
        return "FFN products"
    stack = [e]
    while stack:
        x = stack.pop()
        if x.name in ("aten::bmm", "aten::mm") and len(x.input_shapes) > 1:
            if x.input_shapes[1][-1] == vocab:
                return "unembedding"
            return "attention projections (q, k, v, o)"
        stack.extend(x.cpu_children)
    return None


def phase_profile(params):
    """Where one full-width olmo-1b prefill and one full-width serve run
    spend device time.  Printed only: a profiler that sees no device
    activity fails nothing."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.train import build_prefill_step, synthetic_batch
    cfg = dataclasses.replace(get_config("olmo-1b"), attn_impl="chunked")
    step, _ = build_prefill_step(cfg, *PREFILL)
    batch = synthetic_batch(cfg, 0, *PREFILL)
    batch.pop("targets")
    step(params, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = device_time_by_name(prof)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    parts = {}
    for e in prof.events():
        part = product_part(e, cfg.vocab)
        if part:
            parts[part] = parts.get(part, 0.0) + e.device_time_total / 1e3
    parts["flash_attention (K3)"] = sum(
        us for name, (us, _) in by_name.items()
        if "flash_attention" in name) / 1e3
    parts["everything else"] = busy_ms - sum(parts.values())
    print(f"[profile] prefill olmo-1b batch {PREFILL[0]} seq {PREFILL[1]} "
          f"bf16: one call, wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * (1 - busy_ms / wall_ms):.1f}% idle) in "
          f"{sum(n for _, n in by_name.values())} device activities",
          flush=True)
    for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  {part}")
    print_ranked(by_name, ["flash_attention"])

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            serve.main(SERVE_FULL)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = device_time_by_name(prof)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    print(f"[profile] serve {' '.join(SERVE_FULL)}: main() wall "
          f"{wall_ms:.3f} ms (params init included), device busy "
          f"{busy_ms:.3f} ms in {sum(n for _, n in by_name.values())} "
          "device activities", flush=True)
    print_ranked(by_name, ["paged_attention", "gather_page"])


def phase_prefill_mamba(params):
    """The SSM prefill path at full mamba2-370m width; returns K4's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.train import build_prefill_step, synthetic_batch
    cfg = get_config("mamba2-370m")
    b, s = PREFILL
    step, _ = build_prefill_step(cfg, b, s)
    batch = synthetic_batch(cfg, 0, b, s)
    batch.pop("targets")
    step(params, batch)                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # The path: counts set to 0 just before, read just after.
    reset_counts()
    t = time.perf_counter()
    e0.record()
    logits = step(params, batch)
    e1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    launches = ss.launches
    finite = bool(torch.isfinite(logits).all())
    print(f"[prefill mamba2-370m] batch {b} seq {s} bf16, {cfg.n_layers} "
          f"layers: logits {tuple(logits.shape)} {logits.dtype} "
          f"finite={finite}; ssd_scan launches={launches}; one call "
          f"{e0.elapsed_time(e1):.3f} ms by CUDA events ({wall:.3f} ms host "
          f"wall); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if tuple(logits.shape) != (b, cfg.vocab) or not finite:
        fail("prefill mamba2-370m: logits of the wrong shape or not finite")
    if launches != cfg.n_layers:
        fail(f"prefill mamba2-370m: ssd_scan launched {launches} times for "
             f"{cfg.n_layers} layers")
    return launches


def phase_decode_mamba(params):
    """O(1)-state decode (plain PyTorch, no kernel) against the K4 forward,
    both in f32 at full mamba2-370m width: the forward over 256 tokens (two
    128-step chunks), then 160 tokens one at a time.  Tolerance 2e-3 of the
    logits' largest magnitude plus 2e-3 of each (the logits reach only
    ~0.2 at this init, so a bare 2e-3 would say little): f32 throughout,
    sums in different orders, through 48 layers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import ssm
    from repro_torch.train import build_decode_step, synthetic_batch
    tol, n = 2e-3, 160
    cfg = dataclasses.replace(get_config("mamba2-370m"),
                              compute_dtype=torch.float32)
    tokens = torch.as_tensor(synthetic_batch(cfg, 1, 1, 256)["tokens"],
                             device="cuda")
    ss.launches = 0
    with torch.no_grad():
        want = ssm.forward(params, {"tokens": tokens}, cfg)[:, :n]
    torch.cuda.synchronize()
    if ss.launches != cfg.n_layers:
        fail(f"decode mamba2-370m: the forward launched ssd_scan "
             f"{ss.launches} times for {cfg.n_layers} layers")
    step, _ = build_decode_step(cfg, 1, 256)
    cache = ssm.init_cache(cfg, 1)
    outs = []
    for i in range(n):
        if i == 1:                # the first step warms up; time the rest
            torch.cuda.synchronize()
            t = time.perf_counter()
        lg, cache = step(params, cache, np.array([i], np.int32),
                         tokens[:, i:i + 1])
        outs.append(lg[:, 0])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    got = torch.stack(outs, 1)
    diff = (got - want).abs()
    err = float(diff.max())
    scale = float(want.abs().max())
    print(f"[decode mamba2-370m] f32 batch 1, {n} tokens one at a time "
          f"through build_decode_step (O(1) state, no kernel) vs the K4 "
          f"forward over 256 tokens ({ss.launches} launches, chunk "
          f"{cfg.ssm_chunk}): max_abs_err={err:.3g} (tol {tol} x (|max| + "
          f"|logit|), |logits| <= {scale:.3g}); {wall / (n - 1):.3f} ms a "
          f"step over steps 2-{n} (host wall)", flush=True)
    if bool((diff > tol * scale + tol * want.abs()).any()) \
            or not bool(torch.isfinite(got).all()):
        fail(f"decode mamba2-370m: decode and forward differ by {err:.3g}")


CASTS = ("aten::to", "aten::contiguous")


def cast_part(e):
    """The part of a cast or copy the model makes itself (no aten op above
    it): "param casts" for a weight (rank <= 2), "activation casts" for an
    activation (K4's f32 inputs and its output, the norms' f32 round trip);
    None for any other event."""
    if e.name not in CASTS or not e.input_shapes:
        return None
    parent = e.cpu_parent
    while parent is not None:
        if parent.name.startswith("aten::"):
            return None
        parent = parent.cpu_parent
    return ("param casts" if len(e.input_shapes[0]) <= 2
            else "activation casts")


def phase_profile_mamba(params):
    """Where one full-width mamba2-370m prefill spends device time: K4, the
    in/out projections (``@``), the unembedding (``einsum``), the conv and
    elementwise passes, the param and activation casts, and the rest (other
    copies, norm reductions, the embedding gather).  Printed only."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.train import build_prefill_step, synthetic_batch
    cfg = get_config("mamba2-370m")
    step, _ = build_prefill_step(cfg, *PREFILL)
    batch = synthetic_batch(cfg, 0, *PREFILL)
    batch.pop("targets")
    step(params, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = device_time_by_name(prof)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    parts = {"in/out projections": 0.0, "unembedding": 0.0,
             "param casts": 0.0, "activation casts": 0.0}
    for e in prof.events():
        part = cast_part(e)
        if e.name in PRODUCTS and (e.cpu_parent is None
                                   or e.cpu_parent.name not in PRODUCTS):
            part = ("in/out projections" if e.name == "aten::matmul"
                    else "unembedding")
        if part is not None:
            parts[part] += e.device_time_total / 1e3
    parts["ssd_scan (K4)"] = sum(
        us for name, (us, _) in by_name.items() if "ssd_scan" in name) / 1e3
    parts["conv + elementwise"] = sum(
        us for name, (us, _) in by_name.items()
        if "elementwise" in name and "copy" not in name) / 1e3
    parts["the rest"] = busy_ms - sum(parts.values())
    print(f"[profile] prefill mamba2-370m batch {PREFILL[0]} seq "
          f"{PREFILL[1]} bf16: one call, wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * (1 - busy_ms / wall_ms):.1f}% idle) in "
          f"{sum(n for _, n in by_name.values())} device activities",
          flush=True)
    for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  {part}")
    print_ranked(by_name, ["ssd_scan"])


GRANITE = "granite-moe-3b-a800m"
MOE_LEAVES = ("router", "wg", "wi", "wo")
MOE_PARTS = {"attention": "attention (norm, projections, RoPE)",
             "ffn": "MoE: ffn norm and weight casts",
             "moe.route": "MoE: routing and sort",
             "moe.dispatch": "MoE: dispatch",
             "moe.experts": "MoE: expert products",
             "moe.combine": "MoE: combine",
             "adamw": "AdamW"}


def moe_kept(plan, n_experts):
    """(N, E) bool on the host: the experts that each token's kept pairs
    went to."""
    kept = torch.zeros((plan["idx"].shape[0], n_experts), dtype=torch.bool)
    experts = plan["idx"].reshape(-1)[plan["order"]]
    kept[plan["tok"].cpu(), experts.cpu()] = plan["keep"].cpu()
    return kept


def moe_layer_run(params, x, dy, cfg):
    """One MoE FFN layer forward and backward: [y, dx, d router, d wg, d wi,
    d wo]."""
    from repro_torch.models import modules
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    xr = x.detach().requires_grad_()
    y = modules.moe_ffn(leaves, xr, cfg)
    grads = torch.autograd.grad(y, [xr] + [leaves[k] for k in MOE_LEAVES],
                                dy)
    return [y.detach()] + list(grads)


def phase_moe_layer():
    """One granite-moe-3b-a800m MoE FFN layer at full width (d_model 1536,
    40 experts, top 8, ff 512), weights and 8192 tokens (one training
    batch, 2 x 4096) from SEED, f32: forward and backward on the card
    against the same function on the host CPU, for y, dx and the four
    weights' gradients.  A token whose kept experts differ between the two
    (a near-tie of its 8th and 9th logits, or a capacity edge it shifts)
    is counted and left out: its rows of y and dx are not compared and its
    dy is zero on both sides, so that every weight's gradient sums the same
    pairs; fewer than 0.1% may differ.  Each tensor is held to 1e-4 of its
    largest magnitude (f32, sums in other orders).  Forward and backward
    run twice, in f32 and in bf16, and must give the same bits; then the
    bf16 layer (the training path's) is timed by CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import modules
    tol, n = 1e-4, TRAIN[0] * TRAIN[1]
    base = get_config(GRANITE)
    cfg = dataclasses.replace(base, compute_dtype=torch.float32)
    e, d = cfg.n_experts, cfg.d_model
    gen = torch.Generator("cuda").manual_seed(SEED + 7)
    params = modules.materialize(modules.ffn_specs(cfg), gen, device="cuda")
    x = torch.randn((1, n, d), generator=gen, device="cuda")
    dy = torch.randn((1, n, d), generator=gen, device="cuda")
    host = {k: v.cpu() for k, v in params.items()}
    plans = [modules.moe_route((xs[0] @ p["router"]).float(), cfg)
             for p, xs in ((params, x), (host, x.cpu()))]
    differ = (moe_kept(plans[0], e) != moe_kept(plans[1], e)).any(1)
    dropped = int((~plans[0]["keep"]).sum())
    dy = dy * (~differ).to(dy.device)[None, :, None]
    t = time.perf_counter()
    want = moe_layer_run(host, x.cpu(), dy.cpu(), cfg)
    host_s = time.perf_counter() - t
    got = moe_layer_run(params, x, dy, cfg)
    same32 = all(torch.equal(a, b) for a, b in
                 zip(got, moe_layer_run(params, x, dy, cfg)))
    rows = ~differ
    errs, bad = {}, []
    for name, g, w in zip(("y", "dx") + tuple(f"d {k}" for k in MOE_LEAVES),
                          got, want):
        g = g.cpu()
        if not bool(torch.isfinite(g).all()):
            bad.append(name)
        if name in ("y", "dx"):
            g, w = g[0, rows], w[0, rows]
        errs[name] = float((g - w).abs().max()) / float(w.abs().max())
        if errs[name] > tol:
            bad.append(name)
    del got, want

    cfg16 = base                      # bf16 compute, f32 weights
    x16, dy16 = x.bfloat16(), dy.bfloat16()
    runs = [moe_layer_run(params, x16, dy16, cfg16) for _ in range(2)]
    same16 = all(torch.equal(a, b) for a, b in zip(*runs))
    del runs

    def forward():
        with torch.no_grad():
            modules.moe_ffn(params, x16, cfg16)

    # few calls a timing: each queues hundreds of launches
    fwd_ms = device_ms("moe layer forward", forward, iters=3)
    both_ms = device_ms("moe layer forward+backward",
                        lambda: moe_layer_run(params, x16, dy16, cfg16),
                        iters=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        moe_layer_run(params, x16, dy16, cfg16)
        torch.cuda.synchronize()
    by_part = device_parts(prof, (), MOE_PARTS)
    cap = plans[0]["cap"]
    # the expert products: three (E, cap) x (d, ff) products forward, two
    # each for their gradients
    flops = 3 * 2 * e * cap * d * cfg.d_ff
    print(f"[moe layer] {GRANITE} one MoE FFN layer, d {d}, {e} experts, "
          f"top {cfg.top_k}, ff {cfg.d_ff}, {n} tokens (capacity {cap} a "
          f"expert, {e * cap} buffer rows for {n * cfg.top_k} pairs); "
          f"dropped pairs {dropped}; tokens whose kept experts differ "
          f"between card and host {int(differ.sum())} of {n} (left out); "
          f"f32 card against host CPU ({host_s:.1f} s on the CPU), max abs "
          "err / max: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tol {tol}); forward and backward twice bit-identical: f32 "
          f"{same32}, bf16 {same16}", flush=True)
    print(f"[moe layer] bf16 compute, f32 weights (cast in the call): "
          f"forward {fwd_ms:.3f} ms, forward + backward {both_ms:.3f} ms by "
          f"CUDA events (backward {both_ms - fwd_ms:.3f} ms); the expert "
          f"products alone {flops} flops forward, 3x that with their "
          f"gradients: {flops / BF16_FLOPS * 1e3:.4f} and "
          f"{3 * flops / BF16_FLOPS * 1e3:.4f} ms at the bf16 peak",
          flush=True)
    print("[moe layer] bf16 forward + backward by part (profiler, device "
          "ms): " + ", ".join(f"{k} {v:.3f}" for k, v in
                              sorted(by_part.items(), key=lambda kv: -kv[1])),
          flush=True)
    if bad or not (same32 and same16) or int(differ.sum()) >= n / 1000:
        fail(f"moe layer: card and host differ at {bad}, repeats "
             f"bit-identical f32 {same32} bf16 {same16}, "
             f"{int(differ.sum())} tokens routed differently")


def phase_prefill(cfg, b, s, params):
    """A transformer prefill at full width through build_prefill_step: the
    last token's logits, K3 once a layer, one call timed by CUDA events
    after a warm-up (for a MoE model, the warm-up's routing plans give the
    capacity and the pairs dropped); returns K3's launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import build_prefill_step, synthetic_batch
    tag = f"[prefill {cfg.name}]"
    step, _ = build_prefill_step(cfg, b, s)
    batch = synthetic_batch(cfg, 0, b, s)
    batch.pop("targets")
    t = time.perf_counter()
    with routing_plans() as plans:
        step(params, batch)                    # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    moe = ""
    if plans:
        dropped = sum(int((~p["keep"]).sum()) for p in plans)
        moe = (f", {cfg.n_experts} experts top {cfg.top_k} (capacity "
               f"{plans[0]['cap']}; dropped {dropped} of "
               f"{len(plans) * b * s * cfg.top_k} pairs)")
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # The path: counts set to 0 just before, read just after.
    reset_counts()
    t = time.perf_counter()
    e0.record()
    logits = step(params, batch)
    e1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    launches = fa.launches
    finite = bool(torch.isfinite(logits).all())
    print(f"{tag} batch {b} seq {s} bf16, {cfg.n_layers} layers, "
          f"{cfg.n_heads} heads over {cfg.kv_heads} (D {cfg.head_dim})"
          f"{moe}: logits "
          f"{tuple(logits.shape)} {logits.dtype} finite={finite}; "
          f"flash_attention launches={launches}; one call "
          f"{e0.elapsed_time(e1):.3f} ms by CUDA events ({wall:.3f} ms host "
          f"wall; warm-up call {warm_s:.3f} s); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if tuple(logits.shape) != (b, cfg.vocab) or not finite:
        fail(f"prefill {cfg.name}: logits of the wrong shape or not finite")
    if launches != cfg.n_layers:
        fail(f"prefill {cfg.name}: flash_attention launched {launches} "
             f"times for {cfg.n_layers} layers")
    return launches


@contextlib.contextmanager
def routing_plans():
    """Every routing plan ``moe_ffn`` makes inside the block, in order."""
    from repro_torch.models import modules
    route, plans = modules.moe_route, []

    def recording(logits, cfg):
        plans.append(route(logits, cfg))
        return plans[-1]

    modules.moe_route = recording
    try:
        yield plans
    finally:
        modules.moe_route = route


def decode_flips(decode_plans, forward_plans, n, layers):
    """The positions whose experts differ, in any MoE layer, between
    decode (one plan a step and layer) and a forward (one plan a layer)."""
    return sorted({i for i in range(n) for layer in range(layers)
                   if set(decode_plans[i * layers + layer]["idx"][0].tolist())
                   != set(forward_plans[layer]["idx"][i].tolist())})


def phase_decode_moe(params):
    """Dense-cache decode (build_decode_step) against the chunked forward,
    f32, at full granite-moe-3b-a800m width: 32 tokens one at a time.  A
    forward of S tokens has a capacity of max(S/4, 8) pairs an expert and
    can drop pairs; decode (one token, capacity 8 for its 8 distinct
    experts) never does.  So decode is held, at 2e-3, to the forward at
    every position before the first one the forward dropped a pair of (in
    any layer: attention carries a drop to every later position), and at
    every position to the forward with a capacity that drops nothing
    (capacity_factor E / k).  A position whose top 8 differ between
    decode and that forward (a near-tie) and every later one are left out
    and counted."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.train import build_decode_step, synthetic_batch
    tol, n = 2e-3, 32
    cfg = dataclasses.replace(get_config(GRANITE), attn_impl="chunked",
                              compute_dtype=torch.float32)
    whole = dataclasses.replace(cfg,
                                capacity_factor=cfg.n_experts / cfg.top_k)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_batch(cfg, 1, 1, n).items()}
    batch.pop("targets")
    step, _ = build_decode_step(cfg, 1, 64)
    cache = transformer.init_cache(cfg, 1, 64)
    outs = []
    with routing_plans() as plans:
        for i in range(n):
            if i == 1:            # the first step warms up; time the rest
                torch.cuda.synchronize()
                t = time.perf_counter()
            lg, cache = step(params, cache, np.array([i], np.int32),
                             batch["tokens"][:, i:i + 1])
            outs.append(lg[:, 0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        decode_plans = list(plans)
        plans.clear()
        with torch.no_grad():
            want = transformer.forward(params, batch, cfg)
        dropping = list(plans)
        plans.clear()
        with torch.no_grad():
            want_whole = transformer.forward(params, batch, whole)
        whole_plans = list(plans)
    got = torch.stack(outs, 1)
    layers = cfg.n_layers
    # positions with a dropped pair, in any layer of the forward
    dropped = set()
    for plan in dropping:
        dropped.update(plan["tok"][~plan["keep"]].tolist())
    clean = min(dropped, default=n)
    # the first position whose experts differ between decode and the
    # forward that drops nothing, in any layer
    flips = decode_flips(decode_plans, whole_plans, n, layers)
    agree = min(flips, default=n)
    if any((~p["keep"]).any() for p in decode_plans + whole_plans):
        fail("decode granite: decode or the whole-capacity forward dropped "
             "a pair")
    rel = lambda d, w: bool((d > tol + tol * w.abs()).any())  # noqa: E731
    d1 = (got[:, :min(clean, agree)] - want[:, :min(clean, agree)]).abs()
    d2 = (got[:, :agree] - want_whole[:, :agree]).abs()
    err1 = float(d1.max()) if d1.numel() else 0.0
    err2 = float(d2.max()) if d2.numel() else 0.0
    print(f"[decode {GRANITE}] f32 batch 1, {n} tokens one at a time through "
          f"build_decode_step (cache max_seq 64) vs the chunked forward: the "
          f"forward (capacity {dropping[0]['cap']}) dropped "
          f"{sum(int((~p['keep']).sum()) for p in dropping)} pairs over "
          f"{layers} layers, at {len(dropped)} of {n} positions, the first "
          f"at {clean if dropped else 'none'}; max_abs_err before it "
          f"{err1:.3g}; against the forward that drops nothing "
          f"(capacity_factor {whole.capacity_factor:g}) at {agree} "
          f"positions: {err2:.3g} (tol {tol}); positions whose experts "
          f"differ from that forward's: {len(flips)}; "
          f"{wall / (n - 1):.3f} ms a step over steps 2-{n} (host wall)",
          flush=True)
    if rel(d1, want[:, :d1.shape[1]]) or rel(d2, want_whole[:, :agree]) \
            or not bool(torch.isfinite(got).all()) or agree < n // 2:
        fail(f"decode {GRANITE}: decode and forward differ by {err1:.3g} "
             f"and {err2:.3g} ({len(flips)} positions routed "
             "differently)")


def phase_repeat_cut(cfg, layers=8):
    """check_step_repeats on the model cut to ``layers`` layers, full
    width, batch and seq TRAIN, after one step (so the moments are not
    zero): the full model's state does not fit twice on the card."""
    from repro_torch.train import synthetic_batch
    cut = dataclasses.replace(cfg, n_layers=layers)
    b, s = TRAIN
    params, opt, step = train_setup(cut, b, s)
    params, opt, _ = step(params, opt, synthetic_batch(cut, 0, b, s))
    check_step_repeats(f"[train {cfg.name} {layers} of {cfg.n_layers} "
                       "layers]", step, params, opt,
                       synthetic_batch(cut, 1, b, s))


def phase_serve_moe():
    """The serve driver at full granite-moe-3b-a800m width: its counts, K1
    once a decode step and K2 once a compaction."""
    from repro_torch.kernels import gc_compact, paged_attention
    reset_counts()
    counts = run_serve(SERVE_GRANITE, EXPECT_GRANITE)
    k1, k2 = paged_attention.launches, gc_compact.launches
    print(f"[serve {GRANITE}] launches paged_attention={k1} "
          f"gather_page_units={k2}", flush=True)
    if (k1, k2) != (counts["decode_steps"], counts["compaction_steps"]):
        fail(f"serve {GRANITE}: paged_attention {k1} and gather_page_units "
             f"{k2} launches for {counts['decode_steps']} decode steps and "
             f"{counts['compaction_steps']} compactions")


def phase_moe_family():
    """One MoE layer against the host, then granite-moe-3b-a800m's prefill,
    decode, serve and training paths (the repeat check cut to 8 layers,
    the train driver at SMOKE size) and grok-1-314b's prefill cut to 2
    layers; prints the wall of each phase."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    cfg = dataclasses.replace(get_config(GRANITE), attn_impl="chunked")
    grok = dataclasses.replace(get_config("grok-1-314b"), n_layers=2,
                               attn_impl="chunked")
    held = {}

    def prefill():
        held["params"] = full_params(cfg)
        phase_prefill(cfg, *PREFILL, held["params"])

    phases = [
        ("moe layer", phase_moe_layer),
        ("prefill", prefill),
        ("decode", lambda: phase_decode_moe(held.pop("params"))),
        ("serve", phase_serve_moe),
        ("train", lambda: phase_train(
            cfg, [("flash_attention", lambda: fa.launches,
                   2 * cfg.n_layers),
                  ("flash_attention_bwd", lambda: fa.bwd_launches,
                   cfg.n_layers)],
            TRAIN_PARTS[:2], ["flash_attention"], MOE_PARTS, repeat=False)),
        ("repeat check", lambda: phase_repeat_cut(cfg)),
        ("train driver", lambda: run_train_driver(
            ["--arch", GRANITE, "--smoke", "--steps", "4", "--batch", "2",
             "--seq", "32"])),
        ("grok prefill", lambda: phase_prefill(grok, *GROK_PREFILL,
                                               full_params(grok))),
    ]
    wall = {}
    for name, run in phases:
        t = time.perf_counter()
        run()
        torch.cuda.empty_cache()
        wall[name] = time.perf_counter() - t
    print("[moe] phase wall " + ", ".join(
        f"{k} {v:.3f} s" for k, v in wall.items())
        + f"; all {sum(wall.values()):.3f} s", flush=True)


JAMBA = "jamba-v0.1-52b"
QWEN = "qwen2-vl-2b"
HUBERT = "hubert-xlarge"
JAMBA_BLOCKS = 1               # of 4 super-blocks (8 of 32 layers)
JAMBA_TRAIN_EXPERTS = 2        # of 16, top 2 kept
HYBRID_PARTS = {"attention": "attention (norm, projections, RoPE)",
                "mamba": "Mamba-2 (norm, projections, conv, gate, casts)",
                "ffn": "FFN: norms, dense products, weight casts",
                "moe.route": "MoE: routing and sort",
                "moe.dispatch": "MoE: dispatch",
                "moe.experts": "MoE: expert products",
                "moe.combine": "MoE: combine",
                "adamw": "AdamW"}
HYBRID_KERNELS = TRAIN_PARTS[:2] + TRAIN_PARTS_SSM[:2]


def jamba_cfg(**kw):
    """jamba-v0.1-52b at full width, cut to JAMBA_BLOCKS super-blocks, with
    chunked attention (K3)."""
    from repro_torch.configs import get_config
    base = get_config(JAMBA)
    return dataclasses.replace(base, n_layers=JAMBA_BLOCKS * base.attn_every,
                               attn_impl="chunked", **kw)


def n_params(tree):
    from repro_torch.checkpoint import named_leaves
    return sum(x.numel() for _, x in named_leaves(tree))


def phase_prefill_hybrid(cfg, params):
    """jamba's prefill at full width through build_prefill_step (batch 2,
    seq 4096, bf16): K3 once and K4 once for each Mamba position of every
    block, counted; one call by CUDA events after a warm-up (whose routing
    plans give the dropped pairs, F13), its peak memory and one call by
    part.  Returns {kernel: launches}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.train import build_prefill_step, synthetic_batch
    tag = f"[prefill {cfg.name}]"
    b, s = PREFILL
    n_blocks = cfg.n_layers // cfg.attn_every
    step, _ = build_prefill_step(cfg, b, s)
    batch = synthetic_batch(cfg, 0, b, s)
    batch.pop("targets")
    t = time.perf_counter()
    with routing_plans() as plans:
        step(params, batch)                    # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    dropped = sum(int((~p["keep"]).sum()) for p in plans)
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # The path: counts set to 0 just before, read just after.
    reset_counts()
    t = time.perf_counter()
    e0.record()
    logits = step(params, batch)
    e1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    got = {"flash_attention": fa.launches, "ssd_scan": ss.launches}
    want = {"flash_attention": n_blocks,
            "ssd_scan": n_blocks * (cfg.attn_every - 1)}
    finite = bool(torch.isfinite(logits).all())
    print(f"{tag} batch {b} seq {s} bf16, {cfg.n_layers} of 32 layers "
          f"({n_params(params) / 1e9:.2f}B params, f32), {cfg.n_experts} "
          f"experts top {cfg.top_k} (capacity {plans[0]['cap']}; dropped "
          f"{dropped} of {len(plans) * b * s * cfg.top_k} pairs): logits "
          f"{tuple(logits.shape)} {logits.dtype} finite={finite}; launches "
          f"flash_attention={got['flash_attention']} ssd_scan calls="
          f"{got['ssd_scan']} (3 launches each); one call "
          f"{e0.elapsed_time(e1):.3f} ms by CUDA events ({wall:.3f} ms host "
          f"wall; warm-up call {warm_s:.3f} s); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if tuple(logits.shape) != (b, cfg.vocab) or not finite:
        fail(f"prefill {cfg.name}: logits of the wrong shape or not finite")
    if got != want:
        fail(f"prefill {cfg.name}: launched {got}, not {want}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = device_time_by_name(prof)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    totals = device_parts(prof, HYBRID_KERNELS, HYBRID_PARTS)
    # outside autograd the kernels' launches (through ctypes) hang under no
    # op: count them by name
    for keys, part in HYBRID_KERNELS[1::2]:
        if part not in totals:
            totals[part] = sum(us for name, (us, _) in by_name.items()
                               if any(key in name for key in keys)) / 1e3
    unlinked = busy_ms - sum(totals.values())
    if abs(unlinked) > 1e-3:
        totals["other kernels linked to no op"] = unlinked
    print(f"[profile] prefill {cfg.name}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * (1 - busy_ms / wall_ms):.1f}% idle): "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      sorted(totals.items(), key=lambda kv: -kv[1])),
          flush=True)
    return got


def attention_f64(q, k, v, causal=True):
    """K3's function in f64, its result cast back to q's dtype: a reference
    for the f32 paths."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.double().reshape(b, s, hkv, h // hkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.double()) / d ** 0.5
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.double())
    return out.reshape(b, s, h, d).to(q.dtype)


def ssd_f64(x, dt, a, bmat, cmat, chunk, initial_state=None):
    """K4's plain version in f64, its results cast back: a reference for
    the f32 paths."""
    from repro_torch.kernels import ref
    y, state = ref.ssd_chunked_ref(
        *(t.double() for t in (x, dt, a, bmat, cmat)), chunk,
        None if initial_state is None else initial_state.double())
    return y.to(x.dtype), state.float()


@contextlib.contextmanager
def hybrid_path(impl):
    """jamba's attention and SSD scan on one of three paths: "kernel" (K3
    and K4, with their backward kernels), "plain" (their plain versions
    in f32: the naive attention, ref.ssd_chunked_ref) or "f64" (the plain
    versions in f64, attention_f64 and ssd_f64, everything else in f32 as
    on the other two).  Yields the attn_impl to run with."""
    from repro_torch.kernels import ops, ref
    saved = ops.ssd, ops.attention
    if impl == "plain":
        ops.ssd = ref.ssd_chunked_ref
    elif impl == "f64":
        ops.ssd, ops.attention = ssd_f64, attention_f64
    try:
        yield "naive" if impl == "plain" else "chunked"
    finally:
        ops.ssd, ops.attention = saved


def phase_decode_hybrid(params):
    """jamba's decode (plain PyTorch: KV cache at the attention position,
    O(1) conv and SSM state at the Mamba ones) against its forward over
    256 tokens (two 128-step chunks), both in f32 at full width with all
    16 experts: 160 tokens one at a time.  The forwards take
    capacity_factor E/k, so that they drop no pair (F13).  A position
    whose experts differ between decode and a forward (a near-tie of the
    router's logits) and every later one are left out and counted; at
    least half must agree.  At one block F7 makes every stacked weight
    std 1: the residual stream reaches ~5e6, dt ~300 and dt·a ~-6000, so
    the chunked scan's f32 cumsums lose ~1e-4 of its output, and K4's
    products in split TF32 (2^-21) lose 3-7x that.  So the check is
    measured in the run against a reference, the forward with the
    attention and the scan in f64 (hybrid_path "f64"): ``spread`` is the
    plain f32 forward's largest distance from it; decode must lie within
    twice that (its recurrence has no long cumsum), the K3 + K4 forward
    within 8x (split TF32 against f32), each at least 2e-3 of the logits'
    largest magnitude."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import hybrid
    from repro_torch.train import build_decode_step, synthetic_batch
    tol, n, s = 2e-3, 160, 256
    cfg = jamba_cfg(compute_dtype=torch.float32)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    moe_layers = sum(f == "moe" for _, f in hybrid._position_roles(cfg)) \
        * (cfg.n_layers // cfg.attn_every)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_batch(cfg, 1, 1, s).items()}
    batch.pop("targets")
    forwards, routes = {}, {}
    with routing_plans() as plans, torch.no_grad():
        for impl in ["kernel", "plain", "f64"]:
            reset_counts()
            with hybrid_path(impl) as attn:
                forwards[impl] = hybrid.forward(
                    params, batch, dataclasses.replace(cfg, attn_impl=attn)
                )[:, :n]
            torch.cuda.synchronize()
            if impl == "kernel":
                launches = (fa.launches, ss.launches)
            routes[impl] = list(plans)
            plans.clear()
        step, _ = build_decode_step(cfg, 1, s)
        cache = hybrid.init_cache(cfg, 1, s)
        outs = []
        for i in range(n):
            if i == 1:            # the first step warms up; time the rest
                torch.cuda.synchronize()
                t = time.perf_counter()
            lg, cache = step(params, cache, np.array([i], np.int32),
                             batch["tokens"][:, i:i + 1])
            outs.append(lg[:, 0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    if launches != (1, cfg.attn_every - 1):
        fail(f"decode {cfg.name}: the forward launched K3 and K4 {launches}")
    if any((~p["keep"]).any() for r in list(routes.values()) + [plans]
           for p in r):
        fail(f"decode {cfg.name}: a pair was dropped")
    flips = sorted(set().union(*(decode_flips(plans, r, n, moe_layers)
                                 for r in routes.values())))
    agree = min(flips, default=n)
    got = torch.stack(outs, 1)[:, :agree]
    want = forwards["f64"][:, :agree]
    scale = float(want.abs().max())
    err = {k: float((v[:, :agree] - want).abs().max()) if agree else 0.0
           for k, v in (("decode", got), ("kernel", forwards["kernel"]),
                        ("plain", forwards["plain"]))}
    bound = {"decode": max(2 * err["plain"], tol * scale),
             "kernel": max(8 * err["plain"], tol * scale)}
    print(f"[decode {cfg.name}] f32 batch 1, {n} tokens one at a time "
          f"through build_decode_step (KV cache max_seq {s}, O(1) Mamba "
          f"state, no kernel), {cfg.n_experts} experts, against the forward "
          f"over {s} tokens (chunk {cfg.ssm_chunk}; capacity_factor "
          f"{cfg.capacity_factor:g}, no pair dropped) with attention and "
          f"scan in f64: positions whose experts differ {len(flips)} (the "
          f"first at {flips[0] if flips else 'none'}); max abs err over the "
          f"{agree} before it: decode {err['decode']:.3g} (bound "
          f"{bound['decode']:.3g}), the K3 + K4 forward ({launches[0]} K3 "
          f"launch, {launches[1]} K4 calls) {err['kernel']:.3g} (bound "
          f"{bound['kernel']:.3g}), the plain f32 forward {err['plain']:.3g}"
          f"; |logits| <= {scale:.3g}; {wall / (n - 1):.3f} ms a step over "
          f"steps 2-{n} (host wall)", flush=True)
    if any(err[k] > bound[k] for k in bound) \
            or not bool(torch.isfinite(got).all()) or agree < n // 2:
        fail(f"decode {cfg.name}: {err} against {bound} ({len(flips)} "
             "positions routed differently)")


def phase_train_hybrid_f32_check():
    """One f32 step's loss and gradients of jamba at full width, cut to
    one block and JAMBA_TRAIN_EXPERTS experts, batch 1, seq 256 (two
    chunks), remat "full", on three paths (hybrid_path): the kernels (K3
    f32 and K3-bwd, K4 and K4-bwd), their plain versions in f32 (naive
    attention, autograd through ref.ssd_chunked_ref) and in f64 (the
    reference).  The host CPU would take minutes for this model, so the
    tolerance is measured on the card.  F7's std-1 weights at one block
    leave the gradient ill conditioned: dt reaches ~300 and dt·a ~-6000,
    so the chunked scan's f32 cumsums lose ~1e-4 of its output, and the
    step turns that into ~2% of each gradient on the plain path.  K4's
    and K4-bwd's products in split TF32 keep 2^-21 to 2^-22 (the lo·lo
    term is dropped, the tensor cores' sums truncate) against f32's
    2^-24; on the first Mamba position's own inputs the kernel's output
    lies 3-7x farther from f64 than the plain f32 version's (printed),
    and the whole step's gradients ~9-10x (the first run: predicted 8x).
    So each leaf's ‖g − g_f64‖/‖g_f64‖ of the kernel path must lie
    within 16x the plain f32 path's, and within 1e-4 where that is
    smaller: a wrong gradient is off by its own size.  The loss is held
    to 1e-5 relative of the reference's."""
    from repro_torch.checkpoint import named_leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import hybrid
    from repro_torch.train import synthetic_batch
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    base = jamba_cfg(compute_dtype=torch.float32,
                     n_experts=JAMBA_TRAIN_EXPERTS)
    params = full_params(base)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_batch(base, 2, 1, 256).items()}
    res, scan_inputs = {}, []
    for impl in ["kernel", "plain", "f64"]:
        reset_counts()
        with hybrid_path(impl) as attn:
            if impl == "f64":        # keep the first scan's inputs
                f64_scan = ops.ssd
                ops.ssd = lambda *a: (scan_inputs or scan_inputs.append(
                    [t.detach() if torch.is_tensor(t) else t for t in a]),
                    f64_scan(*a))[1]
            cfg = dataclasses.replace(base, attn_impl=attn)
            leaves = [p.detach().requires_grad_()
                      for p in tree_leaves(params)]
            loss = hybrid.loss_fn(tree_unflatten(params, leaves), batch, cfg)
            res[impl] = (float(loss.detach()),
                         torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        got = (fa.launches, fa.bwd_launches, ss.launches, ss.bwd_launches)
        want = (2, 1, 14, 7) if impl == "kernel" else (0, 0, 0, 0)
        if got != want:
            fail(f"train {JAMBA} f32 check: {impl} launched K3, K3-bwd, K4, "
                 f"K4-bwd {got}, not {want}")
    x, dt, a, bm, cm, chunk, init = scan_inputs[0]
    with torch.no_grad():
        ys = {"kernel": ss.ssd_scan(x, dt, a, bm, cm, chunk, init)[0],
              "plain": ref.ssd_chunked_ref(x, dt, a, bm, cm, chunk, init)[0]}
        y64 = ref.ssd_chunked_ref(*(t.double() for t in (x, dt, a, bm, cm)),
                                  chunk, None if init is None
                                  else init.double())[0]
    scan_err = {k: float((v.double() - y64).norm() / y64.norm())
                for k, v in ys.items()}
    print(f"[train {JAMBA} f32 check] the first Mamba position's scan on "
          f"its own inputs (|x| <= {float(x.abs().max()):.4g}, dt "
          f"{float(dt.min()):.3g}-{float(dt.max()):.4g}, dt·a >= "
          f"{float((dt * a).min()):.4g}): ‖y − y_f64‖/‖y_f64‖ K4 "
          f"{scan_err['kernel']:.3g}, plain f32 {scan_err['plain']:.3g}",
          flush=True)
    (lk, gk), (lp, gp), (l64, g64) = res["kernel"], res["plain"], res["f64"]
    loss_rel = abs(lk - l64) / abs(l64)
    rows, bad, worst = [], [], 0.0
    for (name, _), k, p, r in zip(named_leaves(params), gk, gp, g64):
        norm = float(r.norm())
        rel, spread = float((k - r).norm()) / norm, float((p - r).norm()) / norm
        bound = max(16 * spread, 1e-4)
        worst = max(worst, rel / bound)
        rows.append(f"{name} {rel:.3g} (plain {spread:.3g})")
        if rel > bound:
            bad.append(name)
    print(f"[train {JAMBA} f32 check] full width, {base.n_layers} layers, "
          f"{base.n_experts} experts, batch 1 seq 256 f32, remat "
          f"{base.remat}: loss f64 reference {l64:.7f}, kernel {lk:.7f} (rel "
          f"{loss_rel:.3g}, tol 1e-5), plain {lp:.7f}; ‖g − g_f64‖/‖g_f64‖ "
          f"of the kernel path (of the plain f32 path; held to 16x that): "
          + ", ".join(rows) + f"; worst share of its bound {worst:.3g}",
          flush=True)
    if not np.isfinite(lk) or loss_rel > 1e-5 or bad:
        fail(f"train {JAMBA} f32 check: kernel gradients off at "
             f"{bad or 'the loss'}")


def phase_decode_transformer(cfg, params, n=32):
    """Dense-cache decode (build_decode_step) against the chunked (K3)
    forward, f32 at full width: ``n`` tokens one at a time, at 2e-3 (the
    olmo-1b check's tolerance).  Under M-RoPE the forward's three position
    streams are equal, as decode's are."""
    from repro_torch.models import transformer
    from repro_torch.train import build_decode_step, synthetic_batch
    tol = 2e-3
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_batch(cfg, 1, 1, n).items()}
    batch.pop("targets")
    step, _ = build_decode_step(cfg, 1, 64)
    cache = transformer.init_cache(cfg, 1, 64)
    outs = []
    for i in range(n):
        if i == 1:                # the first step warms up; time the rest
            torch.cuda.synchronize()
            t = time.perf_counter()
        lg, cache = step(params, cache, np.array([i], np.int32),
                         batch["tokens"][:, i:i + 1])
        outs.append(lg[:, 0])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    got = torch.stack(outs, 1)
    with torch.no_grad():
        want = transformer.forward(params, batch, cfg)
    diff = (got - want).abs()
    err = float(diff.max())
    print(f"[decode {cfg.name}] f32 batch 1, {n} tokens one at a time "
          f"through build_decode_step (cache max_seq 64) vs the chunked "
          f"forward: max_abs_err={err:.3g} (tol {tol}, |logits| <= "
          f"{float(want.abs().max()):.3g}); {wall / (n - 1):.3f} ms a step "
          f"over steps 2-{n} (host wall)", flush=True)
    if bool((diff > tol + tol * want.abs()).any()) \
            or not bool(torch.isfinite(got).all()):
        fail(f"decode {cfg.name}: decode and forward differ by {err:.3g}")


def phase_forward_audio(cfg, params):
    """hubert-xlarge's forward at full width on 2 x 4096 frames, bf16,
    non-causal: the materialised attention (its D of 80 takes no kernel,
    as in the JAX package), one call by CUDA events after a warm-up, its
    peak memory; no kernel may launch."""
    from repro_torch.models import transformer
    from repro_torch.train import synthetic_batch
    b, s = PREFILL
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_batch(cfg, 0, b, s).items()}
    with torch.no_grad():
        transformer.forward(params, batch, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        reset_counts()
        e0.record()
        logits = transformer.forward(params, batch, cfg)
        e1.record()
        torch.cuda.synchronize()
    from repro_torch.kernels import flash_attention as fa
    finite = bool(torch.isfinite(logits).all())
    print(f"[forward {cfg.name}] batch {b}, {s} frames, bf16, "
          f"{cfg.n_layers} layers, {cfg.n_heads} heads of D {cfg.head_dim}, "
          f"causal={cfg.causal} ({n_params(params) / 1e9:.3f}B params): "
          f"logits {tuple(logits.shape)} {logits.dtype} finite={finite}; "
          f"flash_attention launches={fa.launches}; one call "
          f"{e0.elapsed_time(e1):.3f} ms by CUDA events; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if tuple(logits.shape) != (b, s, cfg.vocab) or not finite \
            or fa.launches:
        fail(f"forward {cfg.name}: logits or launches wrong")


def phase_model_zoo():
    """The last three families at full width: jamba-v0.1-52b cut to
    JAMBA_BLOCKS of 4 super-blocks (prefill with 16 experts, decode in
    f32, training with JAMBA_TRAIN_EXPERTS experts (its repeat check by
    replay from the seed), the f32 gradient check
    and the SMOKE train driver); qwen2-vl-2b (prefill, decode, training);
    hubert-xlarge (a forward, the SMOKE train driver).  Prints the wall of
    each part; returns {path: {kernel: launches}} of the counted paths."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    jamba = jamba_cfg()
    jamba_train = jamba_cfg(n_experts=JAMBA_TRAIN_EXPERTS)
    qwen = dataclasses.replace(get_config(QWEN), attn_impl="chunked")
    hubert = get_config(HUBERT)
    held, paths = {}, {}

    def jamba_prefill():
        held["params"] = full_params(jamba)
        paths[f"{JAMBA} prefill"] = phase_prefill_hybrid(jamba,
                                                         held["params"])

    def jamba_step():
        blocks = jamba_train.n_layers // jamba_train.attn_every
        n_mamba = blocks * (jamba_train.attn_every - 1)
        kernels = [("flash_attention", lambda: fa.launches, 2 * blocks),
                   ("flash_attention_bwd", lambda: fa.bwd_launches, blocks),
                   ("ssd_scan", lambda: ss.launches, 2 * n_mamba),
                   ("ssd_scan_bwd", lambda: ss.bwd_launches, n_mamba)]
        totals = phase_train(jamba_train, kernels, HYBRID_KERNELS,
                             ["flash_attention", "ssd_"], HYBRID_PARTS,
                             repeat="replay", shape=JAMBA_TRAIN)
        paths[f"{JAMBA} train, {TRAIN_STEPS} steps"] = {
            name: n for (name, _, _), n in zip(kernels, totals)}

    def qwen_prefill():
        held["params"] = full_params(qwen)
        paths[f"{QWEN} prefill"] = {"flash_attention": phase_prefill(
            qwen, *PREFILL, held["params"])}

    def qwen_step():
        kernels = [("flash_attention", lambda: fa.launches,
                    2 * qwen.n_layers),
                   ("flash_attention_bwd", lambda: fa.bwd_launches,
                    qwen.n_layers)]
        totals = phase_train(qwen, kernels, TRAIN_PARTS,
                             ["flash_attention"], HYBRID_PARTS)
        paths[f"{QWEN} train, {TRAIN_STEPS} steps"] = {
            name: n for (name, _, _), n in zip(kernels, totals)}

    phases = [
        ("jamba prefill", jamba_prefill),
        ("jamba decode", lambda: phase_decode_hybrid(held.pop("params"))),
        ("jamba train", jamba_step),
        ("jamba f32 check", phase_train_hybrid_f32_check),
        ("jamba train driver", lambda: run_train_driver(
            ["--arch", JAMBA, "--smoke", "--steps", "4", "--batch", "2",
             "--seq", "32"])),
        ("qwen prefill", qwen_prefill),
        ("qwen decode", lambda: phase_decode_transformer(
            qwen, held.pop("params"))),
        ("qwen train", qwen_step),
        ("hubert forward", lambda: phase_forward_audio(
            hubert, full_params(hubert))),
        ("hubert train driver", lambda: run_train_driver(
            ["--arch", HUBERT, "--smoke", "--steps", "4", "--batch", "2",
             "--seq", "32"])),
    ]
    wall = {}
    for name, run in phases:
        t = time.perf_counter()
        run()
        torch.cuda.empty_cache()
        wall[name] = time.perf_counter() - t
        print(f"[zoo] phase wall {name} {wall[name]:.3f} s", flush=True)
    print("[zoo] phase wall " + ", ".join(
        f"{k} {v:.3f} s" for k, v in wall.items())
        + f"; all {sum(wall.values()):.3f} s", flush=True)
    return paths


# The serve example's line: its twin's on the CPU (tests/test_torch_serving.py)
EXPECT_SERVE_EXAMPLE = ("completed=16 decode_steps=34 compactions=7 "
                        "compaction_dmas=248 fragmentation=0.000")
REMAT_POLICIES = ("dots_with_no_batch_dims", "full", "none")


def phase_parallel_train(mesh):
    """olmo-1b at full width (batch 2, seq 4096, bf16 compute, f32 params,
    chunked attention) through build_train_step on the host mesh, under
    each remat policy: TRAIN_STEPS steps each, their time by CUDA events and
    peak memory, and a profiled step under the two checkpointing policies
    (device busy and idle: the selective checkpoint's dispatch mode is
    host work).  Under "dots_with_no_batch_dims" and "full" K3 runs twice
    a layer (the forward and its recompute: no dispatch mode sees its
    ctypes launch, so the policy cannot save its output), under "none"
    once; K3-bwd once a layer.  The profiler must find the same.  Returns
    the dots policy's launches over its run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    base = dataclasses.replace(get_config("olmo-1b"), attn_impl="chunked")
    n = base.n_layers
    stats, totals = {}, None
    for remat in REMAT_POLICIES:
        cfg = dataclasses.replace(base, remat=remat)
        fwd = n if remat == "none" else 2 * n
        stats[remat] = {}
        got = phase_train(
            cfg, [("flash_attention", lambda: fa.launches, fwd),
                  ("flash_attention_bwd", lambda: fa.bwd_launches, n)],
            TRAIN_PARTS, ["flash_attention"], repeat=False, mesh=mesh,
            tag=f"[parallel train {cfg.name} remat={remat}]",
            profile=remat != "none", stats=stats[remat])
        torch.cuda.empty_cache()
        if remat == REMAT_POLICIES[0]:
            totals = got
            by_name = stats[remat]["by_name"]
            k3 = sum(c for name, (_, c) in by_name.items()
                     if "flash_attention" in name
                     and "flash_attention_bwd" not in name)
            dq = sum(c for name, (_, c) in by_name.items()
                     if "flash_attention_bwd_dq" in name)
            print(f"[parallel] the profiler's step under {remat}: "
                  f"flash_attention kernels {k3}, flash_attention_bwd dq "
                  f"kernels {dq}", flush=True)
            if (k3, dq) != (2 * n, n):
                fail(f"parallel: the profiler found {k3} K3 and {dq} K3-bwd "
                     f"launches in a step under {remat}, for {2 * n} and {n}")
    # the median of steps 2-4: one slow step (allocator growth, the host)
    # moves the mean of three
    print("[parallel] olmo-1b batch 2 seq 4096 by policy, the median of "
          "steps 2-4 by CUDA events (each step's), peak: " + "; ".join(
              f"{r} {float(np.median(stats[r]['times'][1:])):.3f} ms ("
              + ", ".join(f"{t:.3f}" for t in stats[r]["times"][1:])
              + f"), {stats[r]['peak_gib']:.2f} GiB" for r in REMAT_POLICIES),
          flush=True)
    peaks = [stats[r]["peak_gib"] for r in ("full", REMAT_POLICIES[0],
                                            "none")]
    if not peaks[0] < peaks[1] < peaks[2]:
        fail(f"parallel: peaks full/dots/none {peaks} are not in order: the "
             "policy saves no product, or every tensor")
    return totals


def phase_parallel_grads():
    """One f32 step's loss and gradients of olmo-1b at full width cut to 2
    layers (batch 2, seq 1024, chunked attention: K3 and K3-bwd in f32)
    under each remat policy: the same bits in the loss and every leaf.
    Returns the embedding's gradient, a full-width leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import synthetic_batch
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    base = dataclasses.replace(get_config("olmo-1b"), n_layers=2,
                               compute_dtype=torch.float32,
                               attn_impl="chunked")
    params = full_params(base)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_batch(base, 0, 2, 1024).items()}
    runs = {}
    for remat in REMAT_POLICIES:
        cfg = dataclasses.replace(base, remat=remat)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = get_model(cfg).loss_fn(tree_unflatten(params, leaves), batch,
                                      cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        runs[remat] = (loss.detach(), grads)
    torch.cuda.synchronize()
    loss, grads = runs["none"]
    same = {r: torch.equal(l, loss) and all(
        torch.equal(a, b) for a, b in zip(g, grads))
        for r, (l, g) in runs.items()}
    print(f"[parallel grads] olmo-1b 2 layers f32 batch 2 seq 1024: loss "
          f"{float(loss):.6f}; {len(grads)} leaves; the same bits as "
          "\"none\" in the loss and every gradient: " + ", ".join(
              f"{r} {ok}" for r, ok in same.items()), flush=True)
    if not all(same.values()):
        fail(f"parallel: gradients differ between remat policies: {same}")
    return tree_unflatten(params, grads)["embed"]


def phase_int8_allreduce(leaf, card):
    """int8_allreduce in a world-size-1 NCCL group opened through a
    FileStore: equal to int8_quantize dequantized, and to the same function
    on the CPU (a gloo group of the same world), bit for bit; then timed."""
    import torch.distributed as dist

    from repro_torch.parallel import int8_allreduce, int8_quantize
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            cpu_group = dist.new_group([0], backend="gloo")
            got = int8_allreduce(leaf)
            q, scale = int8_quantize(leaf)
            want = q.to(torch.int32).to(leaf.dtype) * (scale / 1)
            host = int8_allreduce(leaf.cpu(), group=cpu_group)
            torch.cuda.synchronize()
            same_q = torch.equal(got, want)
            same_cpu = torch.equal(got.cpu(), host)
            ms = device_ms("int8_allreduce", lambda: int8_allreduce(leaf),
                           iters=20)
            q_ms = device_ms("int8_quantize", lambda: int8_quantize(leaf),
                             iters=20)
        finally:
            dist.destroy_process_group()
    # a bound for the quantize-sum-dequantize passes: x read twice (absmax,
    # quantize), q written and read, the int32 sum written and read, y
    # written
    nbytes = leaf.numel() * (2 * 4 + 2 * 1 + 2 * 4 + 4)
    print(f"[parallel int8] olmo-1b embed gradient {tuple(leaf.shape)} f32 "
          f"through a world-size-1 NCCL group: equal to int8_quantize "
          f"dequantized {same_q}, to the CPU function's result {same_cpu}; "
          f"max |x| {float(leaf.abs().max()):.6g}; int8_allreduce {ms:.4f} "
          f"ms, int8_quantize {q_ms:.4f} ms by CUDA events ({nbytes} bytes "
          f"of unfused passes take {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
          f"at {HBM_BYTES_PER_S / 1e12} TB/s); {card}", flush=True)
    if not (same_q and same_cpu):
        fail("parallel: int8_allreduce differs from int8_quantize or from "
             "the CPU function")


def dryrun_expected_ok():
    from repro_torch.configs import ARCHS
    from repro_torch.launch.shapes import cells
    return 2 * len(cells(ARCHS)[0])


def phase_parallel(card):
    """[parallel]: the mesh, the remat policies, the int8 all-reduce and
    the dry-run on the card.  The dry-run (``python -m
    repro_torch.launch.dryrun --all --out ""``, and again with
    ``--multi-pod``: host work on meta tensors) starts in two
    subprocesses, one a mesh, after the last timed step, so its load is
    in none of the phase's times, and runs beside the serve example; no
    line may be FAIL.  Returns {path: {kernel: launches}}."""
    from repro_torch.launch.mesh import make_host_mesh
    t = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    mesh = make_host_mesh()
    print(f"[parallel] host mesh {mesh.shape} ({mesh.device_type})",
          flush=True)
    totals = phase_parallel_train(mesh)
    leaf = phase_parallel_grads()
    phase_int8_allreduce(leaf, card)
    del leaf
    torch.cuda.empty_cache()
    t_dry = time.perf_counter()
    # one process a mesh: each cell's meta run is host work of its own
    dry = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         *mesh, "--out", ""], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for mesh in ([], ["--multi-pod"])]
    try:
        res = subprocess.run(
            [sys.executable, "examples/torch_serve_paged.py"], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=300)
        line = res.stdout.strip().splitlines()[-1] if res.stdout else ""
        print(f"[parallel serve example] rc {res.returncode}: {line}",
              flush=True)
        if res.returncode or line != EXPECT_SERVE_EXAMPLE:
            fail(f"examples/torch_serve_paged.py: rc {res.returncode}, "
                 f"{line!r}: {res.stderr[-2000:]}")
        outs = [p.communicate(timeout=600) for p in dry]
    finally:
        for p in dry:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"[parallel] dry-run wall {time.perf_counter() - t_dry:.3f} s "
          "(one process a mesh)", flush=True)
    lines = [x for out, _ in outs for x in out.strip().splitlines()]
    for line in lines:
        print(f"[parallel dryrun] {line}", flush=True)
    ok = [x for x in lines if x.startswith("OK ")]
    if any(p.returncode for p in dry) \
            or any(x.startswith("FAIL") for x in lines) \
            or len(ok) != dryrun_expected_ok():
        fail(f"dry-run: rc {[p.returncode for p in dry]}, {len(ok)} OK "
             f"lines for {dryrun_expected_ok()}: "
             + " ".join(err[-1500:] for _, err in outs))
    print(f"[parallel] phase wall {time.perf_counter() - t:.3f} s",
          flush=True)
    return {f"parallel olmo-1b train, remat=dots_with_no_batch_dims, "
            f"{TRAIN_STEPS} steps": {"flash_attention": totals[0],
                                     "flash_attention_bwd": totals[1]}}

# [parallel dp]: the train step across processes on the mesh's data axis
DP_SEQ = 4096                  # olmo-1b, global batch 2 a card
DP_CHECK = (2, 1024)           # the f32 check across cards: layers, seq
NCCL_PARTS = (("AllGather", "all-gather"), ("ReduceScatter",
                                            "reduce-scatter"),
              ("AllReduce", "all-reduce"))


def dp_same_bits(a, b):
    """[(name, max |diff|)] of the leaves of two trees that differ."""
    from repro_torch.checkpoint import named_leaves
    return [(name, float((x.double() - y.double()).abs().max()))
            for (name, x), (_, y) in zip(named_leaves(a), named_leaves(b))
            if not torch.equal(x, y)]


def dp_bits_check(cfg, mesh, batch, what, expect):
    """World 1 only: one sharded step from a state and the one-process
    step from a clone of that state give the same bits in the loss, the
    grad norm and every leaf of params, mu, nu and count.  The sharded
    step takes the split path of a model axis of 1 (``what`` its leaves,
    each one block): the operators of ``runtime.counts`` named in
    ``expect`` must run, and the one-process step must run none."""
    from repro_torch.parallel import runtime
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   build_train_step, init_state)
    from repro_torch.train.optimizer import clone_tree
    from repro_torch.train.step import step_specs
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-3))
    b = len(batch["targets"])
    sharded, _ = build_train_step(cfg, b, DP_SEQ, tc, mesh=mesh)
    one, _ = build_train_step(cfg, b, DP_SEQ, tc)
    (p_spec, _, _), _ = step_specs(cfg, "train", mesh, b, DP_SEQ, tc)
    params = full_params(cfg)
    twin = clone_tree(params)
    params = runtime.shard_tree(params, p_spec, mesh)
    state = [params, init_state(params, tc.adamw)]
    runtime.reset_counts()
    p1, o1, m1, peak1 = own_peak(sharded, state, batch)
    split, gathers = dict(runtime.counts), dict(runtime.gathered)
    p2, o2, m2, peak2 = own_peak(one, [twin, init_state(twin, tc.adamw)],
                                 batch)
    print(f"[parallel tp] world 1: the sharded {cfg.name} step on "
          f"{mesh.shape} took the split path ({what} each one block over "
          f"the model axis): " + ", ".join(f"{k} {v}"
                                           for k, v in split.items())
          + " in one step (remat \"full\" runs each layer's forward twice);"
          f" {gathers['calls']} gathers over data, one layer at a time "
          f"({gathers['bytes'] / 2**30:.3f} GiB, at most "
          f"{gathers['peak'] / 2**30:.3f} GiB alive at once); the "
          f"one-process step none", flush=True)
    if any(split[k] == 0 for k in expect) or runtime.counts != split \
            or not gathers["calls"] \
            or runtime.gathered["calls"] != gathers["calls"]:
        fail(f"parallel tp: the world-1 sharded {cfg.name} step counted "
             f"{split}, {gathers}; with the one-process step "
             f"{dict(runtime.counts)}, {dict(runtime.gathered)}")
    print(f"[parallel dp] world 1: {cfg.name} each step's own peak (its "
          f"params, mu and nu, plus the most it allocated above the memory "
          f"in use before it): sharded {peak1:.2f} GiB, one process "
          f"{peak2:.2f} GiB", flush=True)
    differ = dp_same_bits({"params": p1, "opt": o1, "metrics": m1},
                          {"params": p2, "opt": o2, "metrics": m2})
    print(f"[parallel dp] world 1: one sharded {cfg.name} step from a state "
          f"and the one-process step from a clone of it: loss "
          f"{float(m1['loss']):.6f} / {float(m2['loss']):.6f}, grad_norm "
          f"{float(m1['grad_norm']):.6f} / {float(m2['grad_norm']):.6f}; "
          f"the same bits in the loss, the grad norm and every leaf of "
          f"params, mu, nu and count: {not differ}"
          + (f"; {len(differ)} differ, the first {differ[0]}" if differ
             else ""), flush=True)
    if differ:
        fail(f"parallel dp: the world-1 sharded {cfg.name} step differs "
             f"from the one-process step in {[d[0] for d in differ]}")


def own_peak(step, state, batch):
    """(params, opt, metrics, GiB): ``step(*state, batch)`` and its own
    peak: the bytes of its state (params, mu, nu, count) plus the most it
    allocated above the memory in use before it, which holds other
    states too (and no garbage: the cyclic collector runs first)."""
    import gc

    from repro_torch.train.optimizer import tree_leaves
    held = sum(x.numel() * x.element_size() for tree in state
               for x in tree_leaves(tree))
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(*state, batch)
    torch.cuda.synchronize()
    return (*out, (torch.cuda.max_memory_allocated() - before + held)
            / 2**30)


def dp_param_diffs(a, b):
    """(max |a - b|, the share of elements where |a - b| > 1e-5) over the
    leaves of two param trees."""
    from repro_torch.checkpoint import named_leaves
    worst, over, n = 0.0, 0, 0
    for (_, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
        d = (x.double() - y.double()).abs()
        worst = max(worst, float(d.max()))
        over += int((d > 1e-5).sum())
        n += d.numel()
    return worst, over / n


def verdict(ok, root=0):
    """Every process of the default group learns rank ``root``'s ``ok``, so
    that a failed check ends them all (none is left waiting in a
    collective)."""
    import torch.distributed as dist
    flag = [bool(ok)]
    dist.broadcast_object_list(flag, src=root)
    return flag[0]


def dp_f32_check(mesh, tag, arch="olmo-1b"):
    """More than one process only: one f32 step of ``arch`` (olmo-1b or
    mamba2-370m) cut to DP_CHECK's layers at global batch 2 a ``data``
    coordinate, sharded over the mesh, against the one-process step on the
    whole batch on rank 0.
    The loss is held to twice the f32 spread the same step shows between
    the whole batch and k microbatches (the same sums in another order; k
    the ``data`` size, or 2), and at least 1e-5 relative.  On a mesh
    without a model axis: the grad norm
    (the gradients reduce-scattered and all-reduced by NCCL) to 1e-4
    relative; the params after the step, gathered whole, to
    tests/test_torch_train.py's f32 bounds for one step: 2·lr at the worst
    element and 1e-5 at all but a 1e-3 share.  With a model axis the split
    reorders sums inside every layer (over heads, FFN columns, Mamba-2
    heads and the vocabulary), and the f32 step at this width is ill
    conditioned (ROADMAP F7, F18): so the grad norm and the params are held
    against the same step in f64 on one process (naive attention and the
    plain SSD scan: K3 and K4 have no f64), to at
    most twice the one-process f32 step's own distance from it (and at
    least the bounds above; the worst element to 2·lr and the f32
    rounding of a param, 1e-6).  The same step's f32 spread in the params,
    one process's whole batch against k microbatches, is printed beside
    them."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   build_train_step, init_state,
                                   synthetic_batch)
    from repro_torch.parallel import runtime
    from repro_torch.parallel.sharding import tree_map
    from repro_torch.train.step import step_specs
    layers, seq = DP_CHECK
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              compute_dtype=torch.float32,
                              attn_impl="chunked", remat="full")
    n, split = mesh.shape["data"], mesh.shape["model"] > 1
    b, k = 2 * n, (n if n > 1 else 2)
    batch = synthetic_batch(cfg, 0, b, seq)
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-3))
    step, _ = build_train_step(cfg, b, seq, tc, mesh=mesh)
    (p_spec, _, _), _ = step_specs(cfg, "train", mesh, b, seq, tc)
    params = runtime.shard_tree(full_params(cfg), p_spec, mesh)
    params, _, m = step(params, init_state(params, tc.adamw), batch)
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    params = runtime.gather_whole_tree(params, p_spec, mesh)
    ok = True
    if dist.get_rank() == 0:
        got, ps = [], []
        runs = [(1, cfg), (k, cfg)]
        if split:
            runs.append((1, dataclasses.replace(
                cfg, compute_dtype=torch.float64, param_dtype=torch.float64,
                attn_impl="naive")))
        kernel_ssd = ops.ssd
        for mb, c in runs:
            tcm = TrainConfig(microbatches=mb, adamw=tc.adamw)
            one, _ = build_train_step(c, b, seq, tcm)
            p = tree_map(lambda x: x.to(c.param_dtype), full_params(cfg))
            if c.compute_dtype == torch.float64:
                ops.ssd = ref.ssd_chunked_ref
            try:
                p, _, m1 = one(p, init_state(p, tc.adamw), batch)
            finally:
                ops.ssd = kernel_ssd
            got.append((float(m1["loss"]), float(m1["grad_norm"])))
            ps.append(p)
        spread = abs(got[0][0] - got[1][0])
        bound = max(2 * spread, 1e-5 * abs(got[0][0]))
        own = dp_param_diffs(ps[1], ps[0])
        lr = tc.adamw.lr
        if split:
            # against f64: the split step, and the one-process f32 step
            ref_norm = got[2][1]
            worst, share = dp_param_diffs(params, ps[2])
            one_worst, one_share = dp_param_diffs(ps[0], ps[2])
            norm_bound = max(1e-4 * abs(ref_norm),
                             2 * abs(got[0][1] - ref_norm))
            share_bound = max(1e-3, 2 * one_share)
            # an element whose gradient's sign differs moves 2·lr apart,
            # and an f32 param lies up to its rounding from its f64 twin
            worst_bound = 2 * tc.adamw.lr + 1e-6
            against = (f"the one-process f64 step (naive attention, "
                       f"plain scan): "
                       f"grad_norm {ref_norm:.6f}, the one-process f32 step "
                       f"{got[0][1]:.6f} (|diff| "
                       f"{abs(got[0][1] - ref_norm):.3g}, params max |diff| "
                       f"{one_worst:.3g}, share over 1e-5 {one_share:.3g})")
        else:
            ref_norm = got[0][1]
            worst, share = dp_param_diffs(params, ps[0])
            norm_bound, share_bound = 1e-4 * abs(ref_norm), 1e-3
            worst_bound = 2 * tc.adamw.lr
            against = f"one process {ref_norm:.6f}"
        del ps
        print(f"{tag} f32 check, {cfg.name} {layers} layers, batch {b} "
              f"seq {seq}: loss on {mesh.shape} {loss:.7f}, one "
              f"process {got[0][0]:.7f} (|diff| {abs(loss - got[0][0]):.3g};"
              f" the f32 spread of one process's whole batch against "
              f"{k} microbatches {spread:.3g}; bound {bound:.3g}); "
              f"grad_norm {norm:.6f} against {against}: |diff| "
              f"{abs(norm - ref_norm):.3g} (bound {norm_bound:.3g}); the "
              f"params after the step, gathered: max |diff| {worst:.7g} "
              f"(bound {worst_bound:.7g}), share over 1e-5 {share:.3g} (bound "
              f"{share_bound:.3g}); one process's whole batch against {k} "
              f"microbatches: max |diff| {own[0]:.3g}, share over 1e-5 "
              f"{own[1]:.3g}", flush=True)
        ok = (abs(loss - got[0][0]) <= bound
              and abs(norm - ref_norm) <= norm_bound
              and worst <= worst_bound and share <= share_bound)
    del params
    if not verdict(ok):
        fail(f"{tag}: the f32 step on {mesh.shape} is outside its bounds")


def tp_prefill(mesh, tag):
    """The mesh's prefill at full olmo-1b width (batch 2 a data
    coordinate, seq 4096, K3): in f32, each process's block of the last
    token's logits (its rows over data, its vocabulary columns over model)
    gathered whole, against the one-process prefill in f64 on rank 0
    (naive attention: K3 has no f64), within twice the one-process f32
    prefill's distance from it and at least 1e-5 of the largest |logit|
    (the split reorders sums inside every layer, as ``dp_f32_check``
    says); then in bf16, timed by CUDA events, with its K3 launches on
    every rank."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.parallel import runtime
    from repro_torch.parallel.sharding import tree_map
    from repro_torch.train import build_prefill_step, synthetic_batch
    from repro_torch.train.step import step_specs
    b, seq = 2 * mesh.shape["data"], PREFILL[1]
    for dt in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(get_config("olmo-1b"), attn_impl="chunked",
                                  compute_dtype=dt)
        batch = synthetic_batch(cfg, 0, b, seq)
        batch.pop("targets")
        step, _ = build_prefill_step(cfg, b, seq, mesh=mesh)
        (p_spec, _), out_spec = step_specs(cfg, "prefill", mesh, b, seq)
        whole = full_params(cfg)
        params = runtime.shard_tree(whole, p_spec, mesh)
        if dt == torch.bfloat16:
            del whole
            step(params, batch)
            torch.cuda.synchronize()
            before = fa.launches
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            step(params, batch)
            e1.record()
            torch.cuda.synchronize()
            each = [None] * dist.get_world_size()
            dist.all_gather_object(each, fa.launches - before)
            if dist.get_rank() == 0:
                print(f"{tag} prefill olmo-1b bf16 batch {b} seq {seq} on "
                      f"{mesh.shape}: {e0.elapsed_time(e1):.3f} ms by CUDA "
                      f"events (after one warm-up call); flash_attention "
                      f"launches on each rank {each}", flush=True)
            if set(each) != {cfg.n_layers}:
                fail(f"{tag}: the prefill launched K3 {each} times")
            continue
        got = runtime.gather_whole_tree(step(params, batch), out_spec, mesh)
        ok = True
        if dist.get_rank() == 0:
            one, _ = build_prefill_step(cfg, b, seq)
            want = one(whole, batch)
            cfg64 = dataclasses.replace(cfg, compute_dtype=torch.float64,
                                        param_dtype=torch.float64,
                                        attn_impl="naive")
            exact, _ = build_prefill_step(cfg64, b, seq)
            ref = exact(tree_map(lambda x: x.double(), whole), batch)
            scale = float(ref.abs().max())
            err = float((got.double() - ref).abs().max())
            own = float((want.double() - ref).abs().max())
            bound = max(1e-5 * scale, 2 * own)
            print(f"{tag} prefill f32 check, olmo-1b batch {b} seq {seq}: "
                  f"the blocks of {mesh.shape} gathered {tuple(got.shape)} "
                  f"against the one-process f64 prefill (naive attention): "
                  f"max |diff| {err:.3g}; the one-process f32 prefill's "
                  f"{own:.3g}, and the blocks' against it "
                  f"{float((got - want).abs().max()):.3g} (bound "
                  f"{bound:.3g}: twice the one-process f32 prefill's, at "
                  f"least 1e-5 of the largest |logit| {scale:.4g})",
                  flush=True)
            ok = err <= bound
            del ref
        del whole, params, got
        torch.cuda.empty_cache()
        if not verdict(ok):
            fail(f"{tag}: the prefill's logits differ from one process's")


def tp_granite_step(mesh, tag):
    """granite-moe-3b-a800m at full width on the mesh: 2 training steps
    (global batch 2 a data coordinate, seq 4096, remat "full"), each
    card holding its experts, heads and kv heads (10 of 40, 6 of 24 and 2
    of 8 on a model axis of 4); each step's time, K3 64 and K3-bwd 32
    launches on every rank, and each card's peak memory."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.parallel import runtime
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   build_train_step, init_state,
                                   synthetic_batch)
    from repro_torch.train.step import step_specs
    cfg = dataclasses.replace(get_config(GRANITE), attn_impl="chunked")
    b, seq = 2 * mesh.shape["data"], TRAIN[1]
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-3))
    step, _ = build_train_step(cfg, b, seq, tc, mesh=mesh)
    (p_spec, _, _), _ = step_specs(cfg, "train", mesh, b, seq, tc)
    params = runtime.shard_tree(full_params(cfg), p_spec, mesh)
    opt = init_state(params, tc.adamw)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = (2 * cfg.n_layers, cfg.n_layers)
    for i in range(2):
        before = (fa.launches, fa.bwd_launches)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        params, opt, m = step(params, opt, synthetic_batch(cfg, i, b, seq))
        e1.record()
        torch.cuda.synchronize()
        got = (fa.launches - before[0], fa.bwd_launches - before[1])
        each = [None] * dist.get_world_size()
        dist.all_gather_object(each, got)
        loss = float(m["loss"])
        if dist.get_rank() == 0:
            print(f"{tag} granite-moe-3b-a800m train on {mesh.shape}, global "
                  f"batch {b} seq {seq}, step {i}: loss={loss:.6f} "
                  f"grad_norm={float(m['grad_norm']):.6f}; "
                  f"{e0.elapsed_time(e1):.3f} ms by CUDA events; launches "
                  f"(flash_attention, flash_attention_bwd) on each rank "
                  f"{each}", flush=True)
        if set(each) != {want} or not np.isfinite(loss):
            fail(f"{tag}: granite step {i} launched {each} for {want}, "
                 f"loss {loss}")
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated() / 2**30)
    if dist.get_rank() == 0:
        print(f"{tag} granite-moe-3b-a800m train on {mesh.shape}: peak device "
              f"memory a card " + ", ".join(f"{p:.2f}" for p in peaks)
              + " GiB (the whole model on one card: 69.09 GiB)",
              flush=True)
    del params, opt
    torch.cuda.empty_cache()
    dist.barrier()


MAMBA = "mamba2-370m"
# the sharded decode: (batch, cache max_seq, steps checked in f32, steps
# timed in bf16) and each row's length at the first step: rows whose whole
# sequence lies in the first of 4 blocks of 1024 and rows in each other
TP_DECODE = (8, 4096, 4, 16)
TP_LENGTHS = (0, 7, 700, 1023, 1024, 2500, 3071, 4000)


def tp_mamba_step(mesh, tag):
    """mamba2-370m at full width (48 layers) through the sharded train step,
    global batch 2 a data coordinate, seq 4096, remat "full", bf16 compute:
    at world 1 one step from a state against the one-process step from a
    clone of it (the same bits, through the split path of a model axis of
    1: the Mamba-2 heads, ``w_in``'s blocks gathered by ``gather_blocks``;
    the row is whole, so the gated norm runs fused and no ``psum``); with
    more processes one f32 step at 2
    layers against the f64 one-process step (``dp_f32_check``).  Then
    TRAIN_STEPS steps timed by CUDA events, K4 96 and K4-bwd 48 launches a
    step on every rank by the counters and by a profiled step, and each
    rank's peak memory.  Returns the timed steps' launches."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.parallel import runtime
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   build_train_step, init_state,
                                   synthetic_batch)
    from repro_torch.train.step import step_specs
    world = dist.get_world_size()
    cfg = dataclasses.replace(get_config(MAMBA), remat="full")
    b, n = 2 * mesh.shape["data"], cfg.n_layers
    batches = [synthetic_batch(cfg, i, b, DP_SEQ)
               for i in range(TRAIN_STEPS + 1)]
    if world == 1:
        dp_bits_check(cfg, mesh, batches[0], "Mamba-2 heads, w_in's "
                      "columns, d_inner, vocabulary and embedding rows",
                      ("to_model", "from_model", "vocab_loss",
                       "gather_blocks"))
    else:
        dp_f32_check(mesh, tag, MAMBA)
    torch.cuda.empty_cache()
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-3))
    step, _ = build_train_step(cfg, b, DP_SEQ, tc, mesh=mesh)
    (p_spec, _, _), _ = step_specs(cfg, "train", mesh, b, DP_SEQ, tc)
    params = runtime.shard_tree(full_params(cfg), p_spec, mesh)
    opt = init_state(params, tc.adamw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # The path: counts set to 0 just before, read just after.
    ss.launches = ss.bwd_launches = 0
    times, want = [], (2 * n, n)
    for i in range(TRAIN_STEPS):
        before = (ss.launches, ss.bwd_launches)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        params, opt, m = step(params, opt, batches[i])
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        got = (ss.launches - before[0], ss.bwd_launches - before[1])
        each = [None] * world
        dist.all_gather_object(each, got)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        if dist.get_rank() == 0:
            print(f"{tag} {MAMBA} sharded train on {mesh.shape}, global "
                  f"batch {b} seq {DP_SEQ} step {i}: loss={loss:.6f} "
                  f"grad_norm={norm:.6f}; {times[-1]:.3f} ms by CUDA "
                  f"events; launches (ssd_scan, ssd_scan_bwd) on each rank "
                  f"{each}", flush=True)
        if set(each) != {want} or not (np.isfinite(loss)
                                       and np.isfinite(norm)):
            fail(f"{tag}: {MAMBA} step {i} launched {each} for {want}, "
                 f"loss {loss}, grad_norm {norm}")
    totals = (ss.launches, ss.bwd_launches)
    peaks = [None] * world
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated() / 2**30)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batches[TRAIN_STEPS])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = device_time_by_name(prof)
    k4 = sum(c for name, (_, c) in by_name.items()
             if "ssd_scan_chunk_state" in name)
    k4b = sum(c for name, (_, c) in by_name.items()
              if "ssd_bwd_dstate" in name)
    busy = sum(us for us, _ in by_name.values()) / 1e3
    comm = [0.0, 0]
    for name, (us, c) in by_name.items():
        if name.startswith("Memcpy DtoD") or "nccl" in name.lower():
            comm = [comm[0] + us / 1e3, comm[1] + c]
    counted = [None] * world
    dist.all_gather_object(counted, (k4, k4b))
    if dist.get_rank() == 0:
        print(f"{tag} {MAMBA} sharded train on {mesh.shape}: {TRAIN_STEPS} "
              f"steps, median of steps 2-{TRAIN_STEPS} "
              f"{float(np.median(times[1:])):.3f} ms (" + ", ".join(
                  f"{t:.3f}" for t in times[1:]) + "); peak device memory "
              "a rank " + ", ".join(f"{p:.2f}" for p in peaks) + " GiB; "
              f"launches ssd_scan={totals[0]} ssd_scan_bwd={totals[1]}; "
              f"the profiler's step on rank 0: {wall:.3f} ms host wall, "
              f"device busy {busy:.3f} ms, NCCL kernels and "
              f"device-to-device copies {comm[0]:.3f} ms in {comm[1]}; "
              f"(ssd_scan chunk-state, ssd_scan_bwd dstate) kernels on "
              f"each rank {counted}", flush=True)
    if set(counted) != {want}:
        fail(f"{tag}: the profiler found {counted} K4 and K4-bwd kernels "
             f"in a {MAMBA} step, for {want}")
    del params, opt
    torch.cuda.empty_cache()
    dist.barrier()
    return totals


def random_cache(cfg, b, max_seq):
    """A whole decode cache of normal values from a fixed seed (the same
    values on every process and every call), each part in the dtype the
    model's ``init_cache`` gives it (the SSM state stays f32 in f64
    compute: the model computes it in f32)."""
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import tree_map
    gen = torch.Generator("cuda").manual_seed(SEED + 11)
    model = get_model(cfg)
    cache = (model.init_cache(cfg, b) if cfg.family == "ssm"
             else model.init_cache(cfg, b, max_seq))
    return tree_map(lambda x: torch.randn(x.shape, generator=gen,
                                          device="cuda").to(x.dtype), cache)


def decode_tokens(cfg, b, steps):
    gen = torch.Generator("cuda").manual_seed(SEED + 12)
    return [torch.randint(0, cfg.vocab, (b, 1), generator=gen,
                          device="cuda", dtype=torch.int32)
            for _ in range(steps)]


def tp_decode_check(cfg, mesh, tag, params, note=""):
    """The sharded decode step at full width in f32 (TP_DECODE's batch and
    cache, TP_LENGTHS, its f32 steps) from a cache of normal values, each
    step's logits gathered whole, against the one-process decode from the
    same cache in f32 and in f64 on rank 0 (f64 params and cache; decode
    runs no kernel).  The merge over the cache's blocks and the split
    heads reorder f32 sums, so the mesh's logits are held to the f64
    decode within twice the one-process f32 decode's own distance from it
    (the tolerance measured in this run), and at least 1e-5 of the largest
    |logit|.  ``params`` are the whole f32 params on every process."""
    import torch.distributed as dist

    from repro_torch.parallel import runtime
    from repro_torch.parallel.sharding import tree_map
    from repro_torch.train import build_decode_step, init_cache_blocks
    from repro_torch.train.step import step_specs
    b, max_seq, steps, _ = TP_DECODE
    world = dist.get_world_size()
    lengths = np.asarray(TP_LENGTHS, np.int32)
    tokens = decode_tokens(cfg, b, steps)
    (p_spec, c_spec, _, _), (l_spec, _) = step_specs(cfg, "decode", mesh, b,
                                                     max_seq)
    # at world 1 a block is the whole tensor: no second copy of the params
    blocks = params if world == 1 else runtime.shard_tree(params, p_spec,
                                                          mesh)
    cache = init_cache_blocks(cfg, b, max_seq, mesh)
    with torch.no_grad():
        whole = random_cache(cfg, b, max_seq)
        if isinstance(cache, dict):
            for k in cache:
                cache[k].copy_(runtime.local_block(whole[k], c_spec[k],
                                                   mesh))
        else:
            cache.copy_(runtime.local_block(whole, c_spec, mesh))
        del whole
    step, _ = build_decode_step(cfg, b, max_seq, mesh=mesh)
    runtime.reset_counts()
    got = []
    for t in range(steps):
        logits, cache = step(blocks, cache, lengths + t, tokens[t])
        got.append(runtime.gather_whole_tree(logits, l_spec, mesh))
    counts = dict(runtime.counts)
    del cache, blocks
    got = torch.stack(got)
    ok = True
    if dist.get_rank() == 0:
        res = []
        for dt in (torch.float32, torch.float64):
            c = dataclasses.replace(cfg, compute_dtype=dt, param_dtype=dt)
            p = params if dt == torch.float32 else tree_map(
                lambda x: x.double(), params)
            one, _ = build_decode_step(c, b, max_seq)
            state = random_cache(c, b, max_seq)
            out = []
            for t in range(steps):
                logits, state = one(p, state, lengths + t, tokens[t])
                out.append(logits.double())
            res.append(torch.stack(out))
            del p, state
            torch.cuda.empty_cache()
        one32, ref = res
        scale = float(ref.abs().max())
        err = float((got.double() - ref).abs().max())
        own = float((one32 - ref).abs().max())
        bound = max(1e-5 * scale, 2 * own)
        print(f"{tag} decode f32 check, {cfg.name}{note} batch {b}, cache "
              f"max_seq {max_seq}, lengths {list(TP_LENGTHS)} + t, {steps} "
              f"steps on {mesh.shape}: the blocks' logits gathered against "
              f"the one-process f64 decode: max |diff| {err:.3g}; the "
              f"one-process f32 decode's {own:.3g}, and the blocks' against "
              f"it {float((got.double() - one32).abs().max()):.3g} (bound "
              f"{bound:.3g}: twice the one-process f32 decode's, at least "
              f"1e-5 of the largest |logit| {scale:.4g}); operators "
              + ", ".join(f"{k} {v}" for k, v in counts.items() if v),
              flush=True)
        ok = err <= bound and bool(torch.isfinite(got).all()) \
            and counts["seq_merge" if cfg.family != "ssm" else "psum"] > 0
        del res, one32, ref
    del got
    torch.cuda.empty_cache()
    if not verdict(ok):
        fail(f"{tag}: the sharded {cfg.name} decode differs from one "
             f"process's")


def tp_decode_timed(cfg, mesh, tag, params):
    """The sharded decode step at full width in bf16 (TP_DECODE's batch,
    cache and timed steps, TP_LENGTHS), each step's host wall after one
    warm-up step, as ``phase_decode_transformer`` times it; one more step
    under the profiler (device busy, the largest kernels); and on rank 0
    the one-process decode of the same batch and cache, timed the same
    way."""
    import torch.distributed as dist

    from repro_torch.models import get_model
    from repro_torch.parallel import runtime
    from repro_torch.train import build_decode_step, init_cache_blocks
    from repro_torch.train.step import step_specs
    b, max_seq, _, steps = TP_DECODE
    cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    world = dist.get_world_size()
    (p_spec, _, _, _), _ = step_specs(cfg, "decode", mesh, b, max_seq)
    blocks = params if world == 1 else runtime.shard_tree(params, p_spec,
                                                          mesh)
    cache = init_cache_blocks(cfg, b, max_seq, mesh)
    lengths = np.asarray(TP_LENGTHS, np.int32)
    tokens = decode_tokens(cfg, b, steps + 1)
    step, _ = build_decode_step(cfg, b, max_seq, mesh=mesh)
    for t in range(steps + 1):
        if t == 1:                # the first step warms up; time the rest
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        logits, cache = step(blocks, cache, lengths + t, tokens[t])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    walls = [None] * world
    dist.all_gather_object(walls, wall)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(blocks, cache, lengths + steps + 1, tokens[0])
        torch.cuda.synchronize()
        one = (time.perf_counter() - t0) * 1e3
    by_name = device_time_by_name(prof)
    busy = sum(us for us, _ in by_name.values()) / 1e3
    if dist.get_rank() == 0:
        print(f"{tag} decode bf16 {cfg.name} batch {b}, cache max_seq "
              f"{max_seq} on {mesh.shape}: "
              + ", ".join(f"{w:.3f}" for w in walls)
              + f" ms a step on each rank over steps 2-{steps + 1} (host "
              f"wall); logits block {tuple(logits.shape)}; the profiler's "
              f"step on rank 0: {one:.3f} ms host wall, device busy "
              f"{busy:.3f} ms in {sum(n for _, n in by_name.values())} "
              f"kernels, the most:", flush=True)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        for name, (us, n) in ranked[:8]:
            print(f"{tag}   {us / 1e3:9.3f} ms {n:5d}x {name[:90]}",
                  flush=True)
        # the one-process decode on the same card, whole params and cache
        one, _ = build_decode_step(cfg, b, max_seq)
        state = get_model(cfg).init_cache(
            cfg, b, **({} if cfg.family == "ssm" else {"max_seq": max_seq}))
        for t in range(steps + 1):
            if t == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            _, state = one(params, state, lengths + t, tokens[t])
        torch.cuda.synchronize()
        print(f"{tag} decode bf16 {cfg.name}: the one-process decode on "
              f"rank 0's card, the same batch and cache, "
              f"{(time.perf_counter() - t0) * 1e3 / steps:.3f} ms a step "
              f"over steps 2-{steps + 1} (host wall)", flush=True)
        del state
    dist.barrier()
    if not bool(torch.isfinite(logits.float()).all()):
        fail(f"{tag}: the bf16 {cfg.name} decode gave non-finite logits")
    del blocks, cache
    torch.cuda.empty_cache()


def tp_decode(mesh, tag):
    """The decode step across processes at full width: olmo-1b (the KV
    cache split along its sequence, merged by log-sum-exp) and
    mamba2-370m (the heads' SSM state split, the conv window whole), each
    in f32 against one process and timed in bf16; at world 1 also jamba
    cut to 1 of its 4 blocks with 2 of its 16 experts (the world-1 step
    gathers a second copy of the params over ``data``; all 16 do not fit
    twice), in f32."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    t = time.perf_counter()
    for arch in ("olmo-1b", MAMBA):
        cfg = dataclasses.replace(get_config(arch),
                                  compute_dtype=torch.float32)
        params = full_params(cfg)
        tp_decode_check(cfg, mesh, tag, params)
        tp_decode_timed(cfg, mesh, tag, params)
        del params
        torch.cuda.empty_cache()
    if dist.get_world_size() == 1:
        cfg = jamba_cfg(n_experts=2, compute_dtype=torch.float32)
        params = full_params(cfg)
        tp_decode_check(cfg, mesh, tag, params,
                        f" ({JAMBA_BLOCKS} of 4 blocks, 2 of 16 experts)")
        del params
        torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        print(f"{tag} decode phase wall {time.perf_counter() - t:.3f} s",
              flush=True)
    dist.barrier()


def dp_olmo(mesh, tag, plan):
    """olmo-1b at full width through the sharded train step, global batch
    2 a data coordinate, seq 4096, remat "full": at world 1 the bits check
    (``dp_bits_check``), with more processes ``dp_f32_check``; then
    TRAIN_STEPS steps timed by CUDA events with their launches on every
    rank (K3 32 and K3-bwd 16 a step), each rank's peak memory, a
    profiled step (K3 and K3-bwd kernels, NCCL kernels by collective,
    device-to-device copies) and a step whose collectives each rank
    counts, held to the dry-run's ``plan`` (``dp_collectives``).  Returns
    (the timed steps' launches, the first step's loss)."""
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.parallel import runtime
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   build_train_step, init_state,
                                   synthetic_batch)
    from repro_torch.train.step import step_specs
    world = dist.get_world_size()
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    cfg = dp_olmo_cfg()
    b, n = 2 * mesh.shape["data"], cfg.n_layers
    batches = [synthetic_batch(cfg, i, b, DP_SEQ)
               for i in range(TRAIN_STEPS + 1)]
    if world == 1:
        dp_bits_check(cfg, mesh, batches[0], "heads, FFN columns, "
                      "vocabulary and embedding rows",
                      ("to_model", "from_model", "vocab_loss"))
    else:
        dp_f32_check(mesh, tag)
    torch.cuda.empty_cache()
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-3))
    step, _ = build_train_step(cfg, b, DP_SEQ, tc, mesh=mesh)
    (p_spec, _, _), _ = step_specs(cfg, "train", mesh, b, DP_SEQ, tc)
    params = runtime.shard_tree(full_params(cfg), p_spec, mesh)
    opt = init_state(params, tc.adamw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # The path: counts set to 0 just before, read just after.
    reset_counts()
    times, want, first = [], (2 * n, n), None
    for i in range(TRAIN_STEPS):
        before = (fa.launches, fa.bwd_launches)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        params, opt, m = step(params, opt, batches[i])
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        got = (fa.launches - before[0], fa.bwd_launches - before[1])
        each = [None] * world
        dist.all_gather_object(each, got)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        first = loss if first is None else first
        say(f"{tag} olmo-1b global batch {b} seq {DP_SEQ} step "
            f"{i}: loss={loss:.6f} grad_norm={norm:.6f}; "
            f"{times[-1]:.3f} ms by CUDA events; launches "
            f"(flash_attention, flash_attention_bwd) on each rank "
            f"{each}", flush=True)
        if set(each) != {want} or not (np.isfinite(loss)
                                       and np.isfinite(norm)):
            fail(f"{tag}: step {i} launched {each} for {want}, "
                 f"loss {loss}, grad_norm {norm}")
    totals = (fa.launches, fa.bwd_launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    peaks = [None] * world
    dist.all_gather_object(peaks, peak)
    say(f"{tag} {TRAIN_STEPS} steps, median of steps 2-"
        f"{TRAIN_STEPS} {float(np.median(times[1:])):.3f} ms ("
        + ", ".join(f"{t:.3f}" for t in times[1:]) + "); peak device "
        "memory a rank " + ", ".join(f"{p:.2f}" for p in peaks)
        + f" GiB; launches flash_attention={totals[0]} "
        f"flash_attention_bwd={totals[1]}", flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt, batches[TRAIN_STEPS])
        torch.cuda.synchronize()
    by_name = device_time_by_name(prof)
    k3 = sum(c for name, (_, c) in by_name.items()
             if "flash_attention" in name and "bwd" not in name)
    dq = sum(c for name, (_, c) in by_name.items()
             if "flash_attention_bwd_dq" in name)
    busy = sum(us for us, _ in by_name.values()) / 1e3
    nccl, copies = {}, [0.0, 0]
    for name, (us, c) in by_name.items():
        if name.startswith("Memcpy DtoD"):
            copies = [copies[0] + us / 1e3, copies[1] + c]
        for key, part in NCCL_PARTS:
            if "nccl" in name.lower() and key.lower() in name.lower():
                ms, k = nccl.get(part, (0.0, 0))
                nccl[part] = (ms + us / 1e3, k + c)
    counted = [None] * world
    dist.all_gather_object(counted, (k3, dq))
    say(f"{tag} the profiler's step: device busy {busy:.3f} ms; "
        f"(flash_attention, flash_attention_bwd dq) kernels on each "
        f"rank {counted}; NCCL kernels " + (", ".join(
            f"{part} {ms:.3f} ms in {k}"
            for part, (ms, k) in sorted(nccl.items())) or "none")
        + f"; device-to-device copies {copies[0]:.3f} ms in {copies[1]}"
        + (" (a communicator of one rank copies rather than launch a "
           "kernel)" if world == 1 and not nccl else ""), flush=True)
    if set(counted) != {want} or not verdict(world == 1 or nccl):
        fail(f"{tag}: the profiler found {counted} K3 and K3-bwd and "
             f"NCCL {nccl} in a step, for {want} and NCCL kernels")
    dp_collectives(step, (params, opt, batches[0]), plan, tag, nccl)
    del params, opt
    torch.cuda.empty_cache()
    return totals, first


def dp_collectives(step, args, plan, tag, nccl):
    """One more step under the dry-run's counter (``launch.dryrun
    ._MetaCounter``): each rank's collectives by kind, calls and result
    bytes, printed beside the dry-run's plan of that rank on the same mesh
    and global batch (``plan``: ``dryrun_plan``) and the NCCL kernels of
    the profiled step; the two counts must be equal."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    counter = dryrun._MetaCounter()
    with counter:
        step(*args)
    torch.cuda.synchronize()
    mine = {k: c for k, c in sorted(counter.collectives.items())}
    each = [None] * dist.get_world_size()
    dist.all_gather_object(each, mine)
    if dist.get_rank():
        return

    def show(colls):
        return ", ".join(f"{k} {c['calls']} calls {c['bytes']} B"
                         for k, c in colls.items()) or "none"
    for r, got in enumerate(each):
        print(f"{tag} collectives of one step, rank {r}: counted "
              f"{show(got)}; the dry-run's plan {show(plan[str(r)])}; "
              f"equal: {got == plan[str(r)]}", flush=True)
    print(f"{tag} NCCL kernels of the profiled step: " + (", ".join(
        f"{part} {ms:.3f} ms in {k}" for part, (ms, k) in sorted(
            nccl.items())) or "none (one rank: NCCL copies)"), flush=True)
    if any(got != plan[str(r)] for r, got in enumerate(each)):
        fail(f"{tag}: the collectives counted in a step differ from the "
             "dry-run's plan")


def dryrun_plan(cfg, kind, b, seq, world, model=1, pod=1):
    """{rank: {kind: {"calls", "bytes"}}}: the dry-run's plan
    (``launch.dryrun.plan``) of every rank of a mesh of ``world`` for the
    step of ``kind`` of ``cfg`` (an arch's config with overrides), on meta
    tensors in a fake group, in a subprocess: the plan starts a process
    group of its own, which a process in a live one cannot."""
    over = {k: getattr(cfg, k) for k in ("attn_impl", "remat", "n_layers")}
    code = (
        "import dataclasses, json, sys\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch import dryrun\n"
        "arch, over, kind, b, seq, world, model, pod = "
        "json.loads(sys.argv[1])\n"
        "cfg = dataclasses.replace(get_config(arch), **over)\n"
        "print(json.dumps({r: dryrun.plan(cfg, kind, b, seq, model=model, "
        "pod=pod, world=world, rank=r).counter.collectives "
        "for r in range(world)}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c", code, json.dumps(
            [cfg.name, over, kind, b, seq, world, model, pod])],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if res.returncode:
        fail(f"the dry-run's plan: rc {res.returncode}: "
             f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def dp_olmo_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("olmo-1b"), attn_impl="chunked",
                               remat="full")


def sharded_init(cfg, p_spec, mesh):
    """This process's blocks of the params ``full_params`` draws (the same
    generator, seed and order, a leaf at a time), without the whole tree
    on the card: each leaf is drawn whole, its block kept and the rest
    freed."""
    from repro_torch.models import get_model
    from repro_torch.models.modules import materialize
    from repro_torch.parallel import runtime
    gen = torch.Generator("cuda").manual_seed(SEED)

    def build(node, spec):
        if isinstance(node, dict):
            return {k: build(node[k], spec[k]) for k in sorted(node)}
        whole = materialize(node, gen, cfg.param_dtype, "cuda")
        return runtime.local_block(whole, spec, mesh).clone()
    return build(get_model(cfg).specs(cfg), p_spec)


def dp_pod(mesh, tag, loss0):
    """On 2 or more cards, one olmo-1b step on the (pod, data, model) mesh
    (2, cards / 2, 1) from the data mesh's initial state and on its first
    batch (global batch 2 a card, seq 4096, remat "full"): the batch split
    over (pod, data), the params FSDP blocks over ``data`` replicated
    over ``pod``, the gradients reduce-scattered over ``data`` and
    all-reduced over ``pod``.  Its loss must equal the data mesh's first
    loss ``loss0`` within 1e-5 relative.  With one card, a line says it
    waits for more."""
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import runtime
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   build_train_step, init_state,
                                   synthetic_batch)
    from repro_torch.train.step import step_specs
    world = dist.get_world_size()
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    if world < 2 or world % 2:
        say(f"{tag} pod: the (pod, data, model) mesh waits for 2 or more "
            f"cards ({world} here)", flush=True)
        return None
    pod = make_host_mesh(pod=2)
    cfg = dp_olmo_cfg()
    b = 2 * world
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-3))
    step, _ = build_train_step(cfg, b, DP_SEQ, tc, mesh=pod)
    (p_spec, _, _), _ = step_specs(cfg, "train", pod, b, DP_SEQ, tc)
    params = runtime.shard_tree(full_params(cfg), p_spec, pod)
    opt = init_state(params, tc.adamw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = (fa.launches, fa.bwd_launches)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    _, _, m = step(params, opt, synthetic_batch(cfg, 0, b, DP_SEQ))
    e1.record()
    torch.cuda.synchronize()
    launches = (fa.launches - before[0], fa.bwd_launches - before[1])
    loss = float(m["loss"])
    peaks = [None] * world
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated() / 2**30)
    err = abs(loss - loss0) / abs(loss0)
    say(f"{tag} pod: olmo-1b on the mesh {pod.shape}, global batch {b} seq "
        f"{DP_SEQ}, one step from the data mesh's state on its first batch: "
        f"loss={loss:.6f} against {loss0:.6f} on {mesh.shape} (relative "
        f"{err:.3g}, bound 1e-5); {e0.elapsed_time(e1):.3f} ms by CUDA "
        f"events (the first step on this mesh); launches (flash_attention, "
        f"flash_attention_bwd) {launches}; peak device memory a rank "
        + ", ".join(f"{p:.2f}" for p in peaks) + " GiB", flush=True)
    del params, opt
    torch.cuda.empty_cache()
    if not verdict(np.isfinite(loss) and err <= 1e-5):
        fail(f"{tag}: the pod mesh's loss {loss} differs from {loss0}")
    return launches


PHI3 = "phi3-medium-14b"
PHI3_TRAIN = (4, 4096)          # global batch, seq
PHI3_STEPS = 3


def dp_phi3(mesh, tag):
    """On 4 or more cards, phi3-medium-14b at full width (40 layers, 14.66e9
    params) through the sharded train step on the mesh: random weights
    from seed 0 drawn a leaf at a time (``sharded_init``), f32 params,
    bf16 compute, remat "full", AdamW, global batch 4 × 4096, PHI3_STEPS
    steps: each step's loss (finite, equal on every rank), its time by CUDA
    events, K3 80 and K3-bwd 40 launches a step on every rank, and each
    rank's peak memory.  On fewer cards its state (16 B a param, 218 GiB)
    does not fit: a line says so.  Returns the steps' launches, or None."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   build_train_step, init_state,
                                   synthetic_batch)
    from repro_torch.train.step import step_specs
    world = dist.get_world_size()
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    cfg = dataclasses.replace(get_config(PHI3), attn_impl="chunked",
                              remat="full")
    if world < 4:
        say(f"{tag} {PHI3}: skipped on {world} card(s): its f32 params, "
            f"gradients and AdamW moments take 16 B a param, "
            f"{16 * cfg.param_count() / 2**30:.0f} GiB; it runs on 4 cards "
            f"or more", flush=True)
        return None
    b, seq = PHI3_TRAIN
    n = cfg.n_layers
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-3))
    step, _ = build_train_step(cfg, b, seq, tc, mesh=mesh)
    (p_spec, _, _), _ = step_specs(cfg, "train", mesh, b, seq, tc)
    t0 = time.perf_counter()
    params = sharded_init(cfg, p_spec, mesh)
    opt = init_state(params, tc.adamw)
    torch.cuda.synchronize()
    say(f"{tag} {PHI3}: {cfg.param_count() / 1e9:.2f}e9 params, the blocks "
        f"of mesh {mesh.shape} drawn in {time.perf_counter() - t0:.3f} s; "
        f"state a rank {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
        flush=True)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.bwd_launches = 0
    times, losses, want = [], [], (2 * n, n)
    for i in range(PHI3_STEPS):
        before = (fa.launches, fa.bwd_launches)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        params, opt, m = step(params, opt, synthetic_batch(cfg, i, b, seq))
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        got = (fa.launches - before[0], fa.bwd_launches - before[1])
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        each = [None] * world
        dist.all_gather_object(each, (got, loss, norm))
        say(f"{tag} {PHI3} on {mesh.shape}, global batch {b} seq {seq} "
            f"step {i}: loss={loss:.6f} grad_norm={norm:.6f}; "
            f"{times[-1]:.3f} ms by CUDA events; (launches (flash_attention, "
            f"flash_attention_bwd), loss, grad norm) on each rank {each}",
            flush=True)
        losses.append(loss)
        if {e[0] for e in each} != {want} or len({e[1] for e in each}) != 1 \
                or not (np.isfinite(loss) and np.isfinite(norm)):
            fail(f"{tag}: {PHI3} step {i}: {each}, for {want} launches and "
                 "one finite loss")
    peaks = [None] * world
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated() / 2**30)
    say(f"{tag} {PHI3}: {PHI3_STEPS} steps on {mesh.shape}, "
        + ", ".join(f"{t:.3f}" for t in times) + " ms; peak device memory "
        "a rank " + ", ".join(f"{p:.2f}" for p in peaks) + " GiB (of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}); "
        f"launches flash_attention={fa.launches} "
        f"flash_attention_bwd={fa.bwd_launches}", flush=True)
    del params, opt
    torch.cuda.empty_cache()
    return fa.launches, fa.bwd_launches


# the runs of the [parallel dp] phase (``tools/parallel_dp.py --runs``):
# prefill and granite run on a model axis above 1 only, the train driver
# on a model axis of 1 only, pod on 2 cards or more and phi3 on 4 or more
# (each prints why it waits where it does not run)
DP_RUNS = ("olmo", "mamba", "decode", "prefill", "granite", "pod", "phi3",
           "driver")


def dp_worker(rank, world, store_path, model=1, runs=DP_RUNS, plan=None):
    """One process of the [parallel dp] group, on card ``rank``, on a
    (world / model, model) mesh (rank 0 prints): of ``runs``, olmo-1b's
    sharded train steps (``dp_olmo``), with a model axis of 1 its step on
    the pod mesh (``dp_pod``), phi3-medium-14b's steps (``dp_phi3``),
    mamba2-370m's (``tp_mamba_step``), the sharded decode (``tp_decode``)
    and, with a model axis, the mesh's prefill and a granite-moe-3b-a800m
    training step."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a rank that fails leaves the others in a collective: NCCL's watchdog
    # ends them after this long
    runtime.init_group("cuda", dist.FileStore(store_path, world), rank,
                       world, timeout=timedelta(minutes=2))
    try:
        say = print if rank == 0 else (lambda *a, **k: None)
        tag = "[parallel dp]" if model == 1 else "[parallel tp]"
        mesh = make_host_mesh(model=model)
        say(f"{tag} {world} process(es), NCCL, one card each: host "
            f"mesh {mesh.shape}", flush=True)
        totals, loss0 = {}, None
        if "olmo" in runs:
            totals["olmo"], loss0 = dp_olmo(mesh, tag, plan)
        if "pod" in runs and model == 1:
            if loss0 is None:
                say(f"{tag} pod: needs the olmo run's first loss (--runs "
                    "olmo,pod)", flush=True)
            else:
                launches = dp_pod(mesh, tag, loss0)
                if launches:
                    totals["pod"] = launches
        if "phi3" in runs:
            phi3 = dp_phi3(mesh, tag)
            if phi3:
                totals["phi3"] = phi3
        if "mamba" in runs:
            totals["mamba"] = tp_mamba_step(mesh, tag)
        if "decode" in runs:
            tp_decode(mesh, tag)
        if model > 1 and "prefill" in runs:
            tp_prefill(mesh, tag)
        if model > 1 and "granite" in runs:
            tp_granite_step(mesh, tag)
        if rank == 0:
            with open(os.path.join(os.path.dirname(store_path),
                                   "totals.json"), "w") as f:
                json.dump(totals, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dp_driver(world, argv):
    """The train driver under torchrun, one process a card, started."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={world}", "-m", "repro_torch.launch.train",
         *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def dp_finish(proc, timeout=300):
    """(rc, rank 0's lines, stderr) of a dp_driver run; killed at
    ``timeout`` seconds."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out.strip().splitlines(), err


def phase_parallel_dp(card, model=1, runs=DP_RUNS):
    """[parallel dp]: the train step across processes on the mesh's data
    axis, one process a card in an NCCL group (spawned: the parent has
    CUDA up), at full olmo-1b width, global batch 2 a card, seq 4096,
    remat "full", TRAIN_STEPS steps: each step's time by CUDA events,
    each rank's peak memory, the launches (K3 32, K3-bwd 16 a step) on
    every rank by the counters and the profiler, the NCCL kernels' device
    time.  At world 1 a sharded step and the one-process step give the
    same bits, through the split path of a model axis of 1; at world > 1
    an f32 step's loss, grad norm and params equal one process's within
    f32 bounds (``dp_f32_check``).  Then the train driver under torchrun
    at SMOKE size: a crash, the resume and an uninterrupted run.

    With ``model`` > 1 ([parallel tp]) the mesh is (cards / model, model),
    global batch 2 a data coordinate, and the phase adds the mesh's
    full-width prefill (``tp_prefill``) and a granite-moe-3b-a800m
    training step (``tp_granite_step``); the train driver, which runs the
    data axis, is not run.  On either mesh the phase also runs mamba2-370m's
    sharded train step (``tp_mamba_step``) and the sharded decode of
    olmo-1b and mamba2-370m, and at world 1 of jamba (``tp_decode``).
    ``runs`` picks among them (DP_RUNS).  Returns {path: {kernel:
    launches}}."""
    import multiprocessing
    t = time.perf_counter()
    world = torch.cuda.device_count()
    tag = "[parallel dp]" if model == 1 else "[parallel tp]"
    if world % model:
        fail(f"{tag}: {world} card(s) do not split into model={model}")
    torch.cuda.empty_cache()
    cards = sh("nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader").splitlines()
    print(f"{tag} {world} card(s): " + "; ".join(cards), flush=True)
    if world == 1:
        print(f"{tag} one card: the numbers across cards (an f32 "
              f"step over several processes, NCCL between cards) wait for a "
              f"machine with more; {card}", flush=True)
    ctx = multiprocessing.get_context("spawn")
    b = 2 * world // model
    plan = None
    if "olmo" in runs:
        t_plan = time.perf_counter()
        plan = dryrun_plan(dp_olmo_cfg(), "train", b, DP_SEQ, world, model)
        print(f"{tag} the dry-run's plan of the olmo-1b step on every rank "
              f"(meta tensors, a fake group of {world}): "
              f"{time.perf_counter() - t_plan:.3f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="dp_") as tmp:
        procs = [ctx.Process(target=dp_worker,
                             args=(r, world, os.path.join(tmp, "store"),
                                   model, runs, plan))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=900)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            fail(f"{tag}: the workers exited {codes}")
        with open(os.path.join(tmp, "totals.json")) as f:
            totals = json.load(f)
        if model == 1 and "driver" in runs:
            dp_driver_runs(world, tmp)
    print(f"{tag} phase wall {time.perf_counter() - t:.3f} s", flush=True)
    where = f"{world} process(es), model axis {model}"
    k3 = ("flash_attention", "flash_attention_bwd")
    names = {"olmo": (f"olmo-1b train, {where}, global batch {b}, "
                      f"{TRAIN_STEPS} steps", k3),
             "mamba": (f"{MAMBA} train, {where}, global batch {b}, "
                       f"{TRAIN_STEPS} steps", ("ssd_scan", "ssd_scan_bwd")),
             "pod": (f"olmo-1b train, {world} process(es), mesh (2, "
                     f"{world // 2}, 1), global batch {b}, 1 step", k3),
             "phi3": (f"{PHI3} train, {where}, global batch "
                      f"{PHI3_TRAIN[0]}, {PHI3_STEPS} steps", k3)}
    return {f"parallel {tag[10:-1]} {names[k][0]}": {
        names[k][1][0]: n[0], names[k][1][1]: n[1]}
        for k, n in totals.items()}


def dp_driver_runs(world, tmp):
    """The train driver under torchrun at SMOKE size, one process a card:
    a crash after step 5, the resume and an uninterrupted run, which must
    give the same losses."""
    base = ["--smoke", "--device", "cuda", "--steps", "8", "--batch",
            str(2 * world), "--seq", "32", "--ckpt-every", "3"]
    crashed, whole = (os.path.join(tmp, d) for d in ("crashed", "whole"))
    t_driver = time.perf_counter()
    # the crash and the uninterrupted run side by side
    uninterrupted = dp_driver(world, base + ["--ckpt-dir", whole])
    rc, lines, err = dp_finish(dp_driver(
        world, base + ["--ckpt-dir", crashed, "--fail-at", "5"]))
    for line in lines:
        print(f"[parallel dp driver --fail-at 5] {line}", flush=True)
    codes = re.findall(r"exitcode\s*:\s*(-?\d+)", err)
    print(f"[parallel dp driver --fail-at 5] torchrun rc {rc}, the "
          f"processes' exit codes {codes}", flush=True)
    if "42" not in codes or not set(codes) <= {"42", "-15"} \
            or sorted(step_losses(lines)) != list(range(6)):
        fail(f"parallel dp: the crashed run: rc {rc}, {lines}, "
             f"{err[-2000:]}")
    rc, resumed, err = dp_finish(dp_driver(
        world, base + ["--ckpt-dir", crashed, "--resume"]))
    rc2, full, err2 = dp_finish(uninterrupted)
    for label, out in (("--resume", resumed), ("uninterrupted", full)):
        for line in out:
            print(f"[parallel dp driver {label}] {line}", flush=True)
    want = step_losses(full)
    got = step_losses(lines) | step_losses(resumed)
    if rc or rc2 or not resumed or resumed[0] != "resumed from step 5" \
            or sorted(want) != list(range(8)) or got != want:
        fail(f"parallel dp: resume rc {rc}, uninterrupted rc {rc2}: "
             f"{got} against {want}: {err[-2000:]} {err2[-2000:]}")
    print(f"[parallel dp] the driver under torchrun ({world} process(es)): "
          f"crashed after step 5, resumed from step 5, the losses of steps "
          f"0-7 equal to the uninterrupted run's; wall "
          f"{time.perf_counter() - t_driver:.3f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import gc_compact, paged_attention

    phase_build()
    records = [phase_paged_attention(), phase_gc_compact(),
               phase_flash_attention(), phase_flash_attention_bwd(),
               phase_ssd_scan(), phase_ssd_scan_bwd(), phase_ssd_fused()]
    run_serve(SERVE_SMOKE, EXPECT_SMOKE)

    # The serve path: counts set to 0 just before, read just after.
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    counts = run_serve(SERVE_FULL, EXPECT_FULL)
    k1, k2 = paged_attention.launches, gc_compact.launches
    print(f"[serve] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"paged_attention={k1} gather_page_units={k2}", flush=True)
    # With no allocation failure every decode step calls decode_fn once,
    # and decode_fn attends once.
    if k1 != counts["decode_steps"]:
        fail(f"paged_attention launched {k1} times for "
             f"{counts['decode_steps']} decode steps")
    # One K2 launch per compaction that moves a page: every compaction of
    # this traffic does.
    if k2 != counts["compaction_steps"]:
        fail(f"gather_page_units launched {k2} times for "
             f"{counts['compaction_steps']} compactions")
    records[0]["launches"], records[1]["launches"] = k1, k2

    # The prefill path (its counts are set and read inside), then K3 in the
    # model at f32, decode, and GQA at full width.
    cfg = dataclasses.replace(get_config("olmo-1b"), attn_impl="chunked")
    params = full_params(cfg)
    records[2]["launches"] = phase_prefill(cfg, *PREFILL, params)
    phase_prefill_f32_check(params)
    phase_profile(params)
    del params                    # 4.7 GB: make room for starcoder2-3b's 12
    torch.cuda.empty_cache()
    # GQA at full width: 24 heads over 2 KV heads
    cfg = dataclasses.replace(get_config("starcoder2-3b"),
                              attn_impl="chunked")
    phase_prefill(cfg, 1, 2048, full_params(cfg))
    torch.cuda.empty_cache()

    # The training path (its counts are set and read inside): K3 twice and
    # K3-bwd once a layer a step; then the f32 check and the driver.
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    cfg = dataclasses.replace(get_config("olmo-1b"), attn_impl="chunked")
    _, records[3]["launches"] = phase_train(
        cfg, [("flash_attention", lambda: fa.launches, 2 * cfg.n_layers),
              ("flash_attention_bwd", lambda: fa.bwd_launches,
               cfg.n_layers)],
        TRAIN_PARTS, ["flash_attention"], TRAIN_LABELS)
    torch.cuda.empty_cache()
    phase_train_f32_check()
    run_train_driver(["--smoke", "--steps", "4", "--batch", "2",
                      "--seq", "32"])
    run_train_driver(["--steps", "3"])
    torch.cuda.empty_cache()

    # The SSM path: prefill with K4 (its counts are set and read inside),
    # decode against the K4 forward in f32, and a profile.
    from repro_torch.models import ssm
    params = ssm.init(get_config("mamba2-370m"),
                      torch.Generator("cuda").manual_seed(SEED), "cuda")
    records[4]["launches"] = phase_prefill_mamba(params)
    phase_decode_mamba(params)
    phase_profile_mamba(params)
    del params
    torch.cuda.empty_cache()

    # The SSM training path (its counts are set and read inside): K4 and
    # the fused stretch around it twice and their backward once a layer a
    # step; then the f32 check and the train driver.
    from repro_torch.kernels import ssd_fused as sf
    cfg = get_config("mamba2-370m")
    _, records[5]["launches"], records[6]["launches"], *_ = phase_train(
        cfg, [("ssd_scan", lambda: ss.launches, 2 * cfg.n_layers),
              ("ssd_scan_bwd", lambda: ss.bwd_launches, cfg.n_layers),
              ("ssd_conv", lambda: sf.launches, 2 * cfg.n_layers),
              ("ssd_conv_bwd", lambda: sf.bwd_launches, cfg.n_layers),
              ("ssd_gate", lambda: sf.gate_launches, 2 * cfg.n_layers),
              ("ssd_gate_bwd", lambda: sf.gate_bwd_launches,
               cfg.n_layers)],
        TRAIN_PARTS_SSM, ["ssd_", "conv_silu", "gated_rmsnorm"],
        TRAIN_LABELS)
    torch.cuda.empty_cache()
    phase_train_mamba_f32_check()
    run_train_driver(["--arch", "mamba2-370m", "--smoke", "--steps", "4",
                      "--batch", "2", "--seq", "32"])
    torch.cuda.empty_cache()

    # The MoE family (each path's counts are set and read inside).
    phase_moe_family()

    # The hybrid, VLM and audio families (each path's counts are set and
    # read inside); each kernel's record gains its launches on their paths.
    names = ["paged_attention", "gather_page_units", "flash_attention",
             "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd"]
    paths = phase_model_zoo()
    torch.cuda.empty_cache()

    # The mesh, the remat policies, int8_allreduce, the dry-run and the
    # serve example (the dots policy's path is counted inside).
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]
    paths.update(phase_parallel(card))
    torch.cuda.empty_cache()

    # The train step across processes (its counts are set and read in
    # the processes it starts).
    paths.update(phase_parallel_dp(card))
    for name, record in zip(names, records):
        record["paths"] = {path: counts[name]
                           for path, counts in paths.items()
                           if name in counts}

    # Checkpoints: crash and resume through the train driver, then the
    # store's throughput at full width.
    t = time.perf_counter()
    crash_resume("olmo-1b")
    crash_resume("mamba2-370m")
    phase_checkpoint_throughput(card)
    print(f"[checkpoint] phase wall {time.perf_counter() - t:.3f} s",
          flush=True)

    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
