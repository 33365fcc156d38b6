"""The kernel wrappers' launch counters (``ops/kernels/counts.py``) on the
CPU: every wrapper registers its counters; outside a capture a count is a
host add; while a step is captured into a tally (simulated here: the CPU
has no capture) the add is recorded on the tally instead and the host
counter does not move; ``settle`` and the trainer's chunk read move the
tally into the counters. A real capture and its replays are held on the
card in ``tests/test_torch_kernels_cuda.py``."""

import pytest
import torch

from pinnrl_tpu_torch.ops.kernels import counts, fourier_feats, fused_step, mlp, residual_codegen
from pinnrl_tpu_torch.ops.kernels import siren
from pinnrl_tpu_torch.training import step_program

WRAPPERS = {
    "fused_residual_loss": (fused_step.fused_residual_loss, ("launches", "members")),
    "fourier_features": (fourier_feats.fourier_features, ("launches", "jvps", "plain_f64")),
    "siren_layer": (siren.siren_layer, ("launches", "plain_f64")),
    "fused_mlp_score": (mlp.fused_mlp_score, ("launches",)),
    "generated_residual": (residual_codegen.launch, ("launches",)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_every_wrapper_registers_its_counters(name):
    owner, attrs = WRAPPERS[name]
    for attr in attrs:
        assert (owner, attr) in counts.COUNTERS
        assert isinstance(getattr(owner, attr), int)


class _Owner:
    pass


@pytest.fixture
def owner(monkeypatch):
    monkeypatch.setattr(counts, "COUNTERS", [])
    o = _Owner()
    counts.register(o, "launches", "members")
    return o


def test_a_count_outside_a_capture_is_a_host_add(owner):
    tally = counts.tally(torch.device("cpu"))
    counts.add(owner, "launches")
    with counts.tallying(tally):  # a tally, but no capture on this stream
        counts.add(owner, "members", 3)
    assert (owner.launches, owner.members) == (1, 3)
    assert tally.tolist() == [0, 0]


def test_a_captured_count_goes_to_the_tally_and_settles(owner, monkeypatch):
    monkeypatch.setattr(counts, "_capturing", lambda: True)
    tally = counts.tally(torch.device("cpu"))
    with counts.tallying(tally):
        counts.add(owner, "launches")
        counts.add(owner, "members", 4)
        counts.add(owner, "launches")
    assert (owner.launches, owner.members) == (0, 0)  # the capture ran nothing
    assert tally.tolist() == [2, 4]
    counts.settle(tally, tally.tolist())
    assert (owner.launches, owner.members) == (2, 4) and tally.tolist() == [0, 0]
    counts.add(owner, "launches")  # the tally is no longer active
    assert owner.launches == 3


@pytest.mark.parametrize("transform", ["jvp", "nested_jvp", "vmap", "grad"])
def test_a_captured_count_inside_a_torch_func_transform(owner, monkeypatch, transform):
    """Kernel 2's jvp rule and the launches under the nested-jvp engine or
    vmap count inside torch.func transforms: the tally add escapes them."""
    monkeypatch.setattr(counts, "_capturing", lambda: True)
    tally = counts.tally(torch.device("cpu"))

    def f(x):
        counts.add(owner, "launches")
        return torch.sin(x)

    x, v = torch.linspace(0.0, 1.0, 4), torch.ones(4)
    with counts.tallying(tally):
        if transform == "jvp":
            torch.func.jvp(f, (x,), (v,))
        elif transform == "nested_jvp":
            torch.func.jvp(lambda y: torch.func.jvp(f, (y,), (v,))[1], (x,), (v,))
        elif transform == "vmap":
            torch.func.vmap(f)(x.reshape(2, 2))  # one call for the batch
        else:
            torch.func.grad(lambda y: f(y).sum())(x)
    assert tally.tolist() == [1, 0] and owner.launches == 0


def test_a_counter_registered_after_the_tally_raises(owner, monkeypatch):
    monkeypatch.setattr(counts, "_capturing", lambda: True)
    tally = counts.tally(torch.device("cpu"))
    late = _Owner()
    counts.register(late, "launches")
    with counts.tallying(tally):
        with pytest.raises(RuntimeError, match="registered after"):
            counts.add(late, "launches")
        with pytest.raises(ValueError):
            counts.add(_Owner(), "launches")  # never registered


def test_the_chunk_read_settles_the_program_tally(owner):
    """The trainer reads a program's tally with its chunk's rows (one read)
    and settles it; the rows are what they were."""
    from test_torch_step_program import _program_run

    tr, params, opt, gens, program = _program_run("uniform", steps=2)
    program.end_epoch(0, 2, lambda r: r)
    rows, scale, pts = tr._read_chunk(program, 1, opt)
    program.tally = counts.tally(torch.device("cpu"))
    program.tally.copy_(torch.tensor([3, 5]))
    program.unsettled = 3
    again = tr._read_chunk(program, 1, opt)
    assert again[0] == rows and again[1] == scale and (again[2] == pts).all()
    assert (owner.launches, owner.members) == (3, 5)
    assert program.tally.tolist() == [0, 0] and program.unsettled == 0
    program.release()
    assert program.tally is None and (owner.launches, owner.members) == (3, 5)


def test_release_settles_what_no_chunk_read_took(owner):
    program = step_program.StepProgram(lambda: torch.zeros(2), "eager", torch.device("cpu"),
                                       capacity=1, epochs=1)
    program.tally = counts.tally(torch.device("cpu"))
    program.tally.copy_(torch.tensor([2, 0]))
    program.unsettled = 2
    program.release()
    assert (owner.launches, owner.members) == (2, 0)
