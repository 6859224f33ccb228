"""Full-waveform inversion (BASELINE config #3): recover a velocity anomaly
from a seismogram through sqrt-checkpointed adjoint gradients, then run
the staggered elastic velocity/stress pair (the port of
``examples/fwi_inversion.py``).

    python examples/torch_port/fwi_inversion.py [--device cpu] [--steps N]

On CUDA tensors every wave step and every step of its adjoint is one
launch of the window kernel (``fwi_gradient`` without ``fused_k``), as is
each elastic sweep."""

import torch

from port_cli import parse, parser

from pystencils_autodiff_tpu_torch.models import (elastic_stress_op,
                                                  elastic_velocity_op,
                                                  fwi_gradient, wave_simulate,
                                                  wave_step_op)

N, STEPS, ITERS, LR, DT, ROW = 24, 200, 120, 0.02, 0.05, 3
ELASTIC_SHAPE, ELASTIC_STEPS, ELASTIC_DT = (32, 32), 50, 0.01
ELASTIC = ["vx", "vy", "sxx", "syy", "sxy"]


def elastic_ops():
    """(velocity op, stress op) of the elastic pair, float64."""
    return (elastic_velocity_op(dt=ELASTIC_DT, dtype="float64"),
            elastic_stress_op(dt=ELASTIC_DT, dtype="float64"))


def single_steps():
    """(op, spatial shape, float type, periodic, differentiated) of every
    single step this example launches: a card run may build their
    libraries before it starts."""
    f64 = torch.float64
    # the wave step is the op wave_simulate and fwi_gradient step with
    return ([(wave_step_op(dt=DT, dtype="float64"), (N, N), f64, False,
              True)]
            + [(op, ELASTIC_SHAPE, f64, False, False)
               for op in elastic_ops()])


def setup(n=N, steps=STEPS, device="cpu"):
    """(anomaly, c_true, u0, observed): a Gaussian anomaly of 0.4 on
    c = 2, a point source at (19, 12), the seismogram at row 3."""
    f64 = dict(dtype=torch.float64, device=device)
    yy, xx = torch.meshgrid(torch.arange(n, **f64), torch.arange(n, **f64),
                            indexing="ij")
    anomaly = 0.4 * torch.exp(-((xx - 12.0) ** 2 + (yy - 12.0) ** 2) / 8.0)
    c_true = 2.0 + anomaly
    u0 = torch.zeros((n, n), **f64)
    u0[19, 12] = 1.0
    _, observed = wave_simulate(c_true, u0, steps, dt=DT, checkpoint="none",
                                record=lambda s: s["u_curr"][ROW, :])
    return anomaly, c_true, u0, observed


def invert(u0, observed, steps=STEPS, iters=ITERS, lr=LR):
    """Adam on c from 2 with ``fwi_gradient``'s (value, gradient):
    (first misfit, last misfit, c)."""
    c = torch.full_like(u0, 2.0).requires_grad_()
    opt = torch.optim.Adam([c], lr=lr)
    v0 = None
    for _ in range(iters):
        v, g = fwi_gradient(c.detach(), u0, observed, ROW, steps, dt=DT,
                            checkpoint="sqrt")
        if v0 is None:
            v0 = v
        c.grad = g
        opt.step()
    return v0.item(), v.item(), c.detach()


def elastic(shape=ELASTIC_SHAPE, steps=ELASTIC_STEPS, device="cpu"):
    """The five fields after ``steps`` velocity/stress steps from a unit
    normal-stress source at the centre."""
    fv, fs = (op.torch_function() for op in elastic_ops())
    state = {k: torch.zeros(shape, dtype=torch.float64, device=device)
             for k in ELASTIC}
    mid = tuple(s // 2 for s in shape)
    state["sxx"][mid] = 1.0
    state["syy"][mid] = 1.0
    for _ in range(steps):
        state["vx"], state["vy"] = fv(**state)
        state["sxx"], state["syy"], state["sxy"] = fs(**state)
    return state


def correlation(a, b):
    return torch.corrcoef(torch.stack([a.ravel(), b.ravel()]))[0, 1].item()


def main(argv=None):
    ap = parser(__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=ITERS,
                    help=f"Adam steps (default {ITERS})")
    args, dev = parse(ap, argv)
    anomaly, _, u0, observed = setup(device=dev)
    print("observed seismogram energy:", observed.square().sum().item())
    v0, v, c = invert(u0, observed, iters=args.steps)
    corr = correlation(c - 2.0, anomaly)
    print(f"FWI misfit: {v0:.4e} -> {v:.4e}  (reduction {v0 / v:.0f}x)")
    print(f"recovered-anomaly correlation with truth: {corr:.3f}")
    if args.steps >= ITERS:
        # single-shot FWI is underdetermined; the misfit is the real test
        assert v < v0 / 1000 and corr > 0.1
    else:
        assert v < v0
    print("FWI OK")
    state = elastic(device=dev)
    e = sum(t.square().sum() for t in state.values()).item()
    nan = any(bool(t.isnan().any()) for t in state.values())
    print(f"elastic energy after {ELASTIC_STEPS} steps: {e:.4f}  nan={nan}")
    assert e > 0 and not nan
    print("ELASTIC OK")
    return {"misfit0": v0, "misfit": v, "corr": corr, "energy": e}


if __name__ == "__main__":
    main()
