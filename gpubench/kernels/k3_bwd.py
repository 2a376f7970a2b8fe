"""K3-bwd: the causal attention backward (``csrc/flash_attention_bwd.cu``;
its delta, dk/dv and dq launches)."""

from gpubench.reference import cost

COUNTER = "flash_attention.bwd_launches"


def matches(name: str) -> bool:
    return "flash_attention_bwd_" in name


def work(run):
    c = run.config
    return (*cost.attention_bwd(
        run.traffic["batch"] // run.world, run.traffic["seq"], c["n_heads"],
        c["kv_heads"], c["head_dim"], 2), "bfloat16")
