"""Differentiable lid-driven cavity (D2Q9 BGK, half-way bounce-back walls):
the port of ``examples/lbm_cavity.py``.

    python examples/torch_port/lbm_cavity.py [--device cpu] [--steps N]

A closed box with three no-slip walls and a moving lid develops its
primary clockwise vortex; the lid velocity is then recovered from the
observed flow by gradient descent (the bounce-back boundary is plain
PyTorch, so autograd reaches ``u_lid``), and the same cavity runs as one
fused stage chain per k cycles with its fused backward.

On CUDA tensors the stepper launches the window kernel once a step (and
once a step of its backward); the fused chain launches kernel 12 once a
call and its fused backward kernel 13 once a call."""

import numpy as np
import torch

from port_cli import parse, parser

from pystencils_autodiff_tpu_torch.boundary import BoundaryHandling
from pystencils_autodiff_tpu_torch.models.lbm import (D2Q9_WEIGHTS,
                                                      d2q9_bgk_op,
                                                      macroscopic)
from pystencils_autodiff_tpu_torch.ops import fused_stage_chain
from pystencils_autodiff_tpu_torch.timeloop import make_time_stepper

N, STEPS, OMEGA, U_LID_TRUE = 48, 1500, 1.7, 0.1
M_STEPS, ITERS, RATE, U_START = 200, 20, 8e-3, 0.05
K = 2
F64 = torch.float64
BOUNDARY = {"f": ("bounce_back", "solid", ("uw0", "uw1"))}


def single_steps():
    """(op, spatial shape, float type, periodic, differentiated) of every
    single step this example launches: a card run may build their
    libraries before it starts."""
    return [(d2q9_bgk_op(omega=OMEGA), (N, N), F64, False, True)]


class Cavity:
    """The cavity's op, masks and equilibrium start on one device."""

    def __init__(self, n=N, device="cpu"):
        self.n, self.device = n, torch.device(device)
        solid = torch.zeros((n, n), dtype=torch.bool)
        solid[0, :] = solid[-1, :] = solid[:, 0] = solid[:, -1] = True
        self.solid = solid.to(self.device)
        self.lid_mask = torch.zeros((n, n), dtype=F64, device=self.device)
        self.lid_mask[0, :] = 1.0
        self.zeros = torch.zeros((n, n), dtype=F64, device=self.device)
        self.op = d2q9_bgk_op(omega=OMEGA)
        w = [float(x) for x in D2Q9_WEIGHTS]
        # rho = 1, u = 0
        self.f_eq0 = torch.stack([wi * torch.ones((n, n), dtype=F64)
                                  for wi in w], -1).to(self.device)
        self.chain = fused_stage_chain(
            [(self.op, {"f": "f_out"})], K, fused_bwd=True,
            boundary=BOUNDARY)

    def run(self, u_lid, f0, n_steps):
        """Bounce-back walls; the lid (row 0) moves with ``u_lid`` (a float
        or a 0-d tensor, differentiable) along axis 1."""
        bh = BoundaryHandling(self.op, {"f": (
            "bounce_back", self.solid, (self.zeros, self.lid_mask * u_lid))})
        step = make_time_stepper(self.op, {"f": "f_out"}, boundary=bh)
        state = {"f": f0}
        for _ in range(n_steps):
            state = step(state)
        return state["f"]

    def run_fused(self, u_lid, f0, n_calls):
        """``n_calls`` calls of the fused chain, K cycles each."""
        state = {"f": f0, "solid": self.solid.to(f0.dtype),
                 "uw0": self.zeros, "uw1": self.lid_mask * u_lid}
        for _ in range(n_calls):
            state = {**state, "f": self.chain(state)["f"]}
        return state["f"]

    def lid(self, value):
        return torch.tensor(value, dtype=F64, device=self.device)

    def fluid_v1(self, f):
        _, _, v1 = macroscopic(f + 1e-30)
        return torch.where(self.solid, 0.0, v1)


def vortex(cav, steps=STEPS):
    """(centreline profile under the lid to the floor, core vorticity)."""
    with torch.no_grad():
        f = cav.run(U_LID_TRUE, cav.f_eq0, steps)
    _, u0, u1 = (t.cpu().numpy() for t in macroscopic(f))
    n, fluid = cav.n, ~cav.solid.cpu().numpy()
    prof = u1[1:-1, n // 2]  # lid-parallel velocity on the vertical centreline
    du1_d0 = np.gradient(np.where(fluid, u1, 0.0), axis=0)
    du0_d1 = np.gradient(np.where(fluid, u0, 0.0), axis=1)
    vort = (du0_d1 - du1_d0)[n // 4: -n // 4, n // 4: -n // 4].mean()
    return prof, vort


def recover(cav, m_steps=M_STEPS, iters=ITERS, start=U_START):
    """Gradient descent on the lid velocity from ``start`` against the
    fluid velocity after ``m_steps`` at the true lid: (u, last loss)."""
    with torch.no_grad():
        v1_t = cav.fluid_v1(cav.run(U_LID_TRUE, cav.f_eq0, m_steps))
    u = cav.lid(start)
    for _ in range(iters):
        ul = u.detach().requires_grad_()
        val = torch.sum((cav.fluid_v1(cav.run(ul, cav.f_eq0, m_steps))
                         - v1_t) ** 2)
        (g,) = torch.autograd.grad(val, ul)
        u = ul.detach() - RATE * g  # ~Newton step: d²loss/du² ~ 1e2 here
    return u.item(), val.item()


def fused_vs_stepper(cav, calls=2):
    """(fused state, stepper state, fused u_lid gradient, stepper one)
    after ``calls`` fused calls, K cycles each."""
    with torch.no_grad():
        f_seq = cav.run(U_LID_TRUE, cav.f_eq0, calls * K)
        f_fus = cav.run_fused(U_LID_TRUE, cav.f_eq0, calls)
    grads = []
    for run, n in ((cav.run_fused, calls), (cav.run, calls * K)):
        ul = cav.lid(U_LID_TRUE).requires_grad_()
        (g,) = torch.autograd.grad(torch.sin(run(ul, cav.f_eq0, n)).sum(),
                                   ul)
        grads.append(g.item())
    return f_fus, f_seq, grads[0], grads[1]


def main(argv=None):
    ap = parser(__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS,
                    help=f"cavity steps of the forward run (default "
                         f"{STEPS}); fewer also cut the recovery's run to "
                         f"at most as many and its asserts to progress")
    args, dev = parse(ap, argv)
    full = args.steps >= STEPS
    cav = Cavity(device=dev)
    prof, vort = vortex(cav, args.steps)
    print(f"cavity {N}x{N}, Re ~ "
          f"{U_LID_TRUE * (N - 2) / ((1 / OMEGA - 0.5) / 3):.0f}, "
          f"{args.steps} steps")
    print(f"centreline u_parallel: under lid {prof[0]:+.4f}, "
          f"bottom return flow {prof.min():+.4f}")
    print(f"core vorticity (clockwise > 0 here): {vort:+.5f}")
    assert prof[0] > 0.01 and (prof.min() < -1e-3 or not full), \
        "primary vortex expected"
    u, val = recover(cav, min(M_STEPS, args.steps))
    print(f"lid-velocity recovery: start {U_START} -> {u:.6f} "
          f"(true {U_LID_TRUE}), loss {val:.3e}")
    assert abs(u - U_LID_TRUE) < (1e-3 if full else U_LID_TRUE - U_START), \
        "gradient should recover the lid velocity"
    print("cavity OK")
    f_fus, f_seq, g_fused, g_seq = fused_vs_stepper(cav)
    np.testing.assert_allclose(f_fus.cpu().numpy(), f_seq.cpu().numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g_fused, g_seq, rtol=1e-10)
    print(f"fused chain (k={K}, in-chain bounce-back, fused backward): "
          f"state and u_lid gradient match the stepper ({g_fused:+.6f})")
    return {"u_lid": u, "grad": g_fused}


if __name__ == "__main__":
    main()
