"""The backward rules of the differentiable collectives (training), on two
CPU ranks over gloo in one job: each is the exact adjoint of its forward
over the ranks, which is JAX's transpose rule in a ``shard_map`` without
replication checks. For a linear collective f and every rank's own x and
cotangent y, sum_r <f(x)_r, y_r> == sum_r <x_r, grad_r>, grad_r the
rank's autograd gradient of <f(x)_r, y_r>. ``pmax_sg`` carries none; and
under ``no_grad`` ``psum_if`` stays in place, as the serving path needs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.launch import mesh  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402

OPS = {
    "psum_if": lambda x, g: C.psum_if(x, g),
    "all_to_all_tiled": lambda x, g: C.all_to_all_tiled(x, g, 1, 0),
    "all_gather_axis": lambda x, g: C.all_gather_axis(x, g, 1),
}


def _job(rank, groups):
    g = groups.sp_group
    gen = torch.Generator().manual_seed(10 + rank)
    out = {}
    for name, f in OPS.items():
        x = torch.randn((4, 6, 3), generator=gen, dtype=torch.float64,
                        requires_grad=True)
        y0 = f(x.detach(), g)               # the shape of f(x)
        y = torch.randn(y0.shape, generator=gen, dtype=torch.float64)
        lhs = (f(x, g) * y).sum()
        (grad,) = torch.autograd.grad(lhs, x)
        out[name] = (float(lhs), float((x.detach() * grad).sum()))
    # pmax_sg: the max over ranks, no gradient
    x = torch.randn((5,), generator=gen, requires_grad=True)
    m = C.pmax_sg(x, g)
    out["pmax"] = (m.requires_grad, m.numpy().copy(), x.detach().numpy())
    # under no_grad the sum is in place, as before
    t = torch.ones(3)
    with torch.no_grad():
        same = C.psum_if(t, g) is t
    out["in_place"] = same and bool((t == 2).all())
    return out


@pytest.fixture(scope="module")
def ranks():
    return mesh.run_ranks(_job, 2, 1, device="cpu", backend="gloo",
                          timeout_s=120)


@pytest.mark.parametrize("name", list(OPS))
def test_backward_is_the_adjoint_over_ranks(ranks, name):
    lhs = sum(r[name][0] for r in ranks)
    rhs = sum(r[name][1] for r in ranks)
    assert abs(lhs - rhs) <= 1e-9 * max(1.0, abs(lhs)), (name, lhs, rhs)


def test_pmax_sg_has_no_gradient_and_psum_stays_in_place(ranks):
    want = np.maximum(ranks[0]["pmax"][2], ranks[1]["pmax"][2])
    for r in ranks:
        assert r["pmax"][0] is False
        np.testing.assert_array_equal(r["pmax"][1], want)
        assert r["in_place"]
