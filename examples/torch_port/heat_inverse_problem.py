"""Recover a conductivity field κ with torch.optim.Adam through the
differentiable heat stencil (the port of ``examples/heat_inverse_problem.py``),
then probe the op's argument checks.

    python examples/torch_port/heat_inverse_problem.py [--device cpu]

On CUDA tensors each Adam step launches the window kernel twice: the
forward and the derived backward."""

import torch

from port_cli import parse, parser, seeded

from pystencils_autodiff_tpu_torch import (Assignment, AssignmentCollection,
                                           AutoDiffOp, fields)

N, STEPS, LR = 16, 500, 0.05


def make_op():
    u, out, kappa = fields("u, out, kappa", 2)
    step = Assignment(out.center, u[0, 0] + 0.1 * kappa[0, 0] * (
        u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1] - 4 * u[0, 0]))
    return AutoDiffOp([step], op_name="heat_step")


def single_steps():
    """(op, spatial shape, float type, periodic, differentiated) of every
    single step this example launches: a card run may build their
    libraries before it starts."""
    return [(make_op(), (N, N), torch.float64, False, True)]


def inputs(n=N, device="cpu"):
    """(u0, k_true) in float64: u0 ~ N(0, 1), κ = 1 + 0.5·sigmoid(N(0, 1))."""
    u0 = torch.randn((n, n), generator=seeded(0), dtype=torch.float64)
    k_true = 1.0 + 0.5 * torch.sigmoid(
        torch.randn((n, n), generator=seeded(1), dtype=torch.float64))
    return u0.to(device), k_true.to(device)


def run(u0, k_true, steps=STEPS, lr=LR, device="cpu"):
    """Adam on κ from ones against the target ``f(u0, k_true)``: (the loss
    of the last step, κ after ``steps`` updates)."""
    f = make_op().torch_function()
    u0, k_true = u0.to(device), k_true.to(device)
    with torch.no_grad():
        target = f(u=u0, kappa=k_true)
    k = torch.ones_like(u0, requires_grad=True)
    opt = torch.optim.Adam([k], lr=lr)
    for _ in range(steps):
        opt.zero_grad()
        loss = torch.mean((f(u=u0, kappa=k) - target) ** 2)
        loss.backward()
        opt.step()
    return loss.item(), k.detach()


def probes(u0, k_true):
    """The op's refusals, by probe: (exception type, message)."""
    u, out, _ = fields("u, out, kappa", 2)
    f = make_op().torch_function()
    calls = {
        "P1 wrong-arity": lambda: f(u0),
        "P2 bogus kwarg": lambda: f(u=u0, kappa=k_true, bogus=u0),
        "P3 half offset": lambda: u[0.5, 0],
        "P4 off-centre write": lambda: AssignmentCollection(
            [Assignment(out[1, 0], u[0, 0])]),
        "P5 mixed args": lambda: f(u0, kappa=k_true),
    }
    got = {}
    for name, call in calls.items():
        try:
            call()
        except (TypeError, KeyError, ValueError) as e:
            got[name] = (type(e), str(e))
    return got


def main(argv=None):
    args, dev = parse(parser(__doc__.split("\n\n")[0]), argv)
    u0, k_true = inputs(device=dev)
    loss, _ = run(u0, k_true, device=dev)
    print("adam final loss:", loss)
    assert loss < 1e-12
    print("OPTIMIZATION OK")
    got = probes(u0, k_true)
    for name, (kind, msg) in got.items():
        print(f"{name}:", kind.__name__, msg)
    assert got["P5 mixed args"][0] is TypeError
    assert got["P4 off-centre write"][0] is ValueError
    assert len(got) == 5, sorted(got)
    return {"loss": loss}


if __name__ == "__main__":
    main()
