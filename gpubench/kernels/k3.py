"""K3: the causal attention forward (``csrc/flash_attention.cu``)."""

from gpubench.reference import cost

COUNTER = "flash_attention.launches"


def matches(name: str) -> bool:
    return "flash_attention_tc_kernel" in name \
        or "flash_attention_kernel" in name


def work(run):
    c = run.config
    # a forward that training differentiates writes each row's lse
    return (*cost.attention_fwd(
        run.traffic["batch"] // run.world, run.traffic["seq"], c["n_heads"],
        c["kv_heads"], c["head_dim"], 2,
        with_lse=run.traffic["entry"] == "train"), "bfloat16")
