"""The comparison that decides ``correct`` catches a broken timed path: a
run at SMOKE size on the CPU, past the harness's look for a card, with the
program's step broken underneath, comes out not correct under the cell's
own limits, once for each fault the cell can have.  The control (the
reference one precision below the configuration's, put in the program's
place) comes out not correct too."""

import pytest

from gpubench_helpers import context, read_json, smoke_config, smoke_traffic

from gpubench import cells, port, weights
from gpubench.entries import prefill, train
from gpubench.reference.models import Precision

TRAIN_CELLS = [("olmo-1b.train", "olmo-1b"),
               ("mamba2-370m.train", "mamba2-370m")]


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _largest_stacked(params):
    flat = weights.flatten(params)
    return max((v for k, v in flat.items() if k.startswith("layers.")),
               key=lambda v: v.numel())


def unchanged(step):
    """A step that returns its state unchanged (its loss is the real
    one)."""
    def broken(params, opt, batch):
        _, _, m = step(_clone(params), _clone(opt), batch)
        return params, opt, m
    return broken


def half_batch(step):
    """Half of the batch left out: the mean over the rest."""
    def broken(params, opt, batch):
        n = batch["tokens"].shape[0] // 2
        return step(params, opt, {k: v[:n] for k, v in batch.items()})
    return broken


def update_dropped(step):
    """An answer altered where it is produced: one layer's update of one
    leaf lost."""
    def broken(params, opt, batch):
        leaf = _largest_stacked(params)
        keep = leaf[0].clone()
        out = step(params, opt, batch)
        leaf[0].copy_(keep)
        return out
    return broken


def _broken_train(monkeypatch, fault):
    real = port.train_step

    def train_step(cfg, traffic, device, mesh=None):
        step, abstract = real(cfg, traffic, device, mesh)
        return fault(step), abstract
    monkeypatch.setattr(port, "train_step", train_step)


def _train_ctx(cell, arch):
    traffic = [w for w in read_json("BENCHMARK.json")["workloads"]
               if w["name"] == cell][0]["traffic"]
    tr = smoke_traffic(traffic)
    return context(smoke_config(arch), tr,
                   read_json(f"gpubench/limits/{cell}.json"),
                   seed=2 ** 31 + 77)


@pytest.mark.parametrize("cell,arch", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_batch, update_dropped],
                         ids=lambda f: f.__name__)
def test_training_faults_are_not_correct(smoke_port, monkeypatch, cell, arch,
                                         fault):
    _broken_train(monkeypatch, fault)
    result = cells.run(_train_ctx(cell, arch))
    assert not result["correct"], result["checks"]


def test_olmo_training_control_is_not_correct(smoke_port):
    from gpubench import checks
    ctx = _train_ctx("olmo-1b.train", "olmo-1b")
    ref, ctrl = _control(ctx)
    correct, got = checks.verdict(checks.train_numbers(ctrl, ref),
                                  ctx.limits)
    assert not correct, got


# Mamba-2's full-size readings (the worst unit is a_log or dt_bias, 32
# values a layer, their gradients summed over 32,768 tokens) do not shrink
# to a CPU size: there sound runs and the control both read about a tenth
# of what they read on the card.  The control is held here to the same
# separation from sound runs that set the cell's limit on the card (the
# control's ``grad`` above three times the sound runs' largest).
MAMBA_SIZE = {"d_model": 128, "headdim": 64, "d_state": 128,
              "chunk_size": 128}


def test_mamba_training_control_separates(smoke_port):
    from gpubench import checks
    smoke_port(d_model=128, ssm_headdim=64, ssm_state=128, ssm_chunk=128)
    limits = read_json("gpubench/limits/mamba2-370m.train.json")
    tr = smoke_traffic("train_8x4096")
    tr["seq"] = 1024
    sound, control = [], []
    for seed in (1, 2, 3):
        ctx = context(smoke_config("mamba2-370m", **MAMBA_SIZE), tr, limits,
                      seed=seed)
        sound.append(cells.run(ctx)["numbers"]["grad"]["value"])
        ref, ctrl = _control(ctx)
        control.append(checks.train_numbers(ctrl, ref)["grad"]["value"])
    assert min(control) > 3 * max(sound), (control, sound)


def _control(ctx):
    _, checked = train.checked_batches(ctx)
    return (train.reference(ctx, checked),
            train.reference(ctx, checked, prec=Precision.control()))


def served_altered(step):
    """The served token altered where it is produced: every row's logits
    shifted by one token, so the argmax names the next token."""
    def broken(params, batch):
        return step(params, batch).roll(1, dims=-1)
    return broken


def half_rows(step):
    """Half of the batch left out: the first prompt's logits served for
    every prompt."""
    def broken(params, batch):
        n = batch["tokens"].shape[0]
        one = step(params, {k: v[:n // 2] for k, v in batch.items()})
        return one.repeat(2, 1)
    return broken


@pytest.mark.parametrize("fault", [served_altered, half_rows],
                         ids=lambda f: f.__name__)
def test_prefill_faults_are_not_correct(smoke_port, monkeypatch, fault):
    real = port.prefill_step

    def prefill_step(cfg, traffic, device):
        step, abstract = real(cfg, traffic, device)
        return fault(step), abstract
    monkeypatch.setattr(port, "prefill_step", prefill_step)
    ctx = context(smoke_config("olmo-1b"), smoke_traffic("prefill_2x4096"),
                  read_json("gpubench/limits/olmo-1b.prefill.json"),
                  seed=2 ** 31 + 78)
    result = cells.run(ctx)
    assert not result["correct"], result["checks"]


# A size at which a CPU test holds the prefill's control: the published
# vocabulary, so that the top logits lie as close together as at full size,
# and as many served tokens for the widest gap as the cell checks (200).
PREFILL_SIZE = {"vocab": 50304, "d_model": 128, "n_layers": 4, "d_ff": 256}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_prefill_control_is_not_correct(smoke_port, seed):
    from gpubench import checks
    smoke_port(**PREFILL_SIZE)
    tr = smoke_traffic("prefill_2x4096")
    tr.update(seq=64, checked_requests=100)
    ctx = context(smoke_config("olmo-1b", head_dim=32, **PREFILL_SIZE), tr,
                  read_json("gpubench/limits/olmo-1b.prefill.json"),
                  seed=seed)
    got = prefill.controls(ctx)["control"]
    correct, got = checks.verdict(got, ctx.limits)
    assert not correct, got


def test_sound_runs_are_correct(smoke_port):
    for cell, arch in TRAIN_CELLS:
        result = cells.run(_train_ctx(cell, arch))
        assert result["correct"], (cell, result["checks"])
    ctx = context(smoke_config("olmo-1b"), smoke_traffic("prefill_2x4096"),
                  read_json("gpubench/limits/olmo-1b.prefill.json"),
                  seed=2 ** 31 + 78)
    assert cells.run(ctx)["correct"]


def _dist_run(tmp_path, fault):
    import multiprocessing

    from gpubench_helpers import dist_worker
    import queue as queues
    world = 4
    tmp_path.mkdir()
    limits = read_json("gpubench/limits/olmo-1b.train_fsdp4.json")
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    procs = [mp.Process(target=dist_worker,
                        args=(r, world, str(tmp_path / "store"), limits,
                              fault, queue)) for r in range(world)]
    for p in procs:
        p.start()
    got = []
    try:
        while len(got) < world:
            try:
                got.append(queue.get(timeout=5))
            except queues.Empty:
                assert any(p.is_alive() for p in procs), \
                    [p.exitcode for p in procs]
        for p in procs:
            p.join(timeout=60)
            assert p.exitcode == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return sorted(got)


def test_four_process_exchange_left_out_is_not_correct(tmp_path):
    sound = _dist_run(tmp_path / "sound", None)
    assert all(correct for _, correct, _ in sound), sound
    broken = _dist_run(tmp_path / "broken", "exchange")
    assert not any(correct for _, correct, _ in broken), broken
