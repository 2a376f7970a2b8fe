"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and
their plain PyTorch versions:

* flash_attention — causal or full GQA attention over a whole sequence
  (prefill, training), with a backward kernel
  (``csrc/flash_attention_bwd.cu``) behind a ``torch.autograd.Function``;
* paged_attention — decode attention against the paged KV pool;
* gc_compact — run-coalesced page-block gather (GC compaction of the pool);
* ssd_scan — the Mamba-2 SSD chunked scan (SSM prefill), with a backward
  kernel;
* ssd_fused — the Mamba-2 layer's conv, gate and norm on either side of
  the scan, forward and backward, behind ``ssd_fused.SSDMixer``.

``ops`` is the public entry; ``ref`` holds the plain versions.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
