"""The reference agrees with the port at SMOKE sizes on the CPU, with
both computing in f32: through the whole of a cell's run, the three
training steps (losses, first gradients, changes) and the served
tokens."""

import pytest
import torch

from gpubench_helpers import context, smoke_config, smoke_traffic

from gpubench import cells, weights
from gpubench.reference import cost
from gpubench.reference.families import family

F32_LIMITS = {"loss": {"limit": 1e-5}, "grad": {"limit": 1e-5},
              "change": {"limit": 1e-5}, "token_gap": {"limit": 1e-6}}


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m"])
@pytest.mark.parametrize("traffic", ["train_8x4096", "prefill_2x4096"])
def test_reference_agrees_with_the_port_in_f32(smoke_port, arch, traffic):
    smoke_port(compute_dtype=torch.float32)
    ctx = context(smoke_config(arch, compute_dtype="float32"),
                  smoke_traffic(traffic), F32_LIMITS, seed=2 ** 33 + 5)
    result = cells.run(ctx)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def test_weights_are_the_same_for_a_seed_and_leaf_by_leaf():
    cfg = smoke_config("mamba2-370m")
    a = weights.flatten(weights.make_params(cfg, 2 ** 32 + 1, "cpu"))
    b = weights.flatten(weights.make_params(cfg, 2 ** 32 + 1, "cpu"))
    c = weights.flatten(weights.make_params(cfg, 2 ** 32 + 2, "cpu"))
    for i, (name, *_) in enumerate(weights.leaf_specs(cfg)):
        assert torch.equal(a[name], b[name])
        assert torch.equal(a[name], weights.leaf(cfg, 2 ** 32 + 1, i, "cpu"))
    assert not torch.equal(a["layers.w_in"], c["layers.w_in"])


def test_model_flops_count_the_products_once():
    cfg = smoke_config("olmo-1b")
    d, f, v, l = cfg["d_model"], cfg["d_ff"], cfg["vocab"], cfg["n_layers"]
    matrices = l * (4 * d * d + 3 * d * f) + d * v
    assert family(cfg).matrix_params(cfg) == matrices
    b, s = 2, 32
    assert cost.model_flops(cfg, b, s, train=False) == \
        2 * matrices * b * s + 2 * s * s * d * b * l
    assert cost.model_flops(cfg, b, s, train=True) == \
        3 * cost.model_flops(cfg, b, s, train=False)


def test_roofline_bounds():
    flops, nbytes = cost.attention_fwd(2, 4096, 16, 16, 128, 2, False)
    assert flops == 4 * 2 * 16 * 128 * 4096 * 4097 // 2
    assert nbytes == 4 * 2 * 4096 * 16 * 128 * 2
    assert cost.bound_s(flops, nbytes, "bfloat16") == flops / 989e12
    f4, b4 = cost.ssd_fwd(2, 4096, 32, 64, 128)
    assert cost.ssd_bwd(2, 4096, 32, 64, 128)[0] == 2 * f4
