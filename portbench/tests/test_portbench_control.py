"""The control: the reference itself in the next precision below the stated
one (float8 products where bf16 is stated, in the forward and the backward
pass), put in the program's place.  At reduced widths it reads at least
three times what the program does in one of the numbers (the bf16 program's
own gaps are large at such widths, as a near-tie in a router of 8 experts
moves a token's gradient); at the cell's own size (on the card) it fails
the cell's limits on every seed."""
import pytest
import torch

from portbench import check, spec
from portbench.entries import train
from portbench.reference.common import F8Product, to_f8

SEED = 2**34 + 11


def test_float8_product_rounds_the_backward_products_too():
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(3, 5, 16, generator=gen, requires_grad=True)
    b = torch.randn(16, 8, generator=gen, requires_grad=True)
    g = torch.randn(3, 5, 8, generator=gen)
    F8Product.apply(a, b).backward(g)
    qa, qb, qg = to_f8(a.detach()), to_f8(b.detach()), to_f8(g, torch.float8_e5m2)
    assert torch.equal(a.grad, qg @ qb.T)
    assert torch.allclose(b.grad, (qa.transpose(1, 2) @ qg).sum(0), rtol=1e-6, atol=1e-5)
    exact = g @ b.detach().T
    assert float((a.grad - exact).norm() / exact.norm()) > 0.02  # e5m2 keeps 2 mantissa bits


def test_control_reads_far_above_the_program_in_training():
    from portbench.tests import small

    conf, mix = small.train_conf(), small.train_mix()
    job = train.Job(conf, mix, "cpu")
    job.load(SEED)
    got = job.checked(SEED)
    job.free()
    want = train.reference(conf, mix, SEED, "cpu")
    program = train.compare(got, want)
    control = train.compare(train.reference(conf, mix, SEED, "cpu", train.CONTROL), want)
    assert max(control[k] / program[k] for k in program) > 3  # it has to fail one number


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_control_fails_the_cells_limits(card, seed):
    w = spec.workload("qwen3moe.train")
    conf, mix, limits = spec.config(w["config"]), spec.traffic(w["traffic"]), spec.limits(w["name"])
    want = train.reference(conf, mix, seed, card)
    readings = train.compare(train.reference(conf, mix, seed, card, train.CONTROL), want)
    assert not check.verdict({k: (v, limits["limits"][k]) for k, v in readings.items()})
