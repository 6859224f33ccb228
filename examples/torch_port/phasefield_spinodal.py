"""Spinodal decomposition with the Cahn–Hilliard two-sweep model, recorded
as a GraphDataHandling program and run by node replay and as a fused stage
chain, then an inverse problem that brackets the mobility (the port of
``examples/phasefield_spinodal.py``).

    python examples/torch_port/phasefield_spinodal.py [--device cpu]

On CUDA tensors the replay and the stage stepper launch the window kernel
once a sweep (two a cycle); the fused chain launches kernel 12 in its
periodic mode once a call of k cycles."""

import torch

from port_cli import parse, parser, seeded

from pystencils_autodiff_tpu_torch.graph_datahandling import \
    GraphDataHandling
from pystencils_autodiff_tpu_torch.models.phasefield import (
    cahn_hilliard_stages, ginzburg_landau_energy)
from pystencils_autodiff_tpu_torch.ops.stage_chain import stage_stepper

N, K, CYCLES, DT = 64, 2, 20, 0.01
MOBILITIES = (0.5, 1.0, 1.5)


def initial_phi(n=N, dtype=torch.float64, device="cpu"):
    """φ0 = 0.1·N(0, 1), drawn on the CPU."""
    phi = 0.1 * torch.randn((n, n), generator=seeded(0), dtype=dtype)
    return phi.to(device)


def _name(dtype):
    return str(dtype).replace("torch.", "")


def stages(dtype=torch.float64, mobility=1.0):
    """The two Cahn–Hilliard sweeps as (op, carry) pairs (the mobility
    enters the update sweep linearly: it scales its dt)."""
    return cahn_hilliard_stages(dt=DT * mobility, dtype=_name(dtype))


def single_steps():
    """(op, spatial shape, float type, periodic, differentiated) of every
    single step this example launches: a card run may build their
    libraries before it starts."""
    return [(op, (N, N), torch.float64, True, False)
            for m in MOBILITIES for op, _ in stages(mobility=m)]


def record(phi0):
    """The datahandling with the two sweeps and the exchange of φ recorded
    in one timeloop, on ``phi0``'s device and float type."""
    n = phi0.shape[0]
    dh = GraphDataHandling((n, n), ghost_layers=0, default_dtype=phi0.dtype,
                           device=phi0.device)
    dh.add_field("phi", init=0.0)
    dh.add_field("mu", init=0.0)
    dh.set_array("phi", phi0)
    with dh.timeloop() as loop:
        for op, carry in stages(phi0.dtype):
            loop.sweep(op, carry)
        loop.communicate("phi")
    return dh


def compiled(dh, k=K):
    """(replay, fused stage chain) of the recorded program, periodic."""
    return (dh.compile(periodic=True),
            dh.compile(fuse="stages", k=k, periodic=True))


def trajectory(state, mobility, n_steps):
    """φ after ``n_steps`` cycles of the stage stepper at ``mobility``."""
    steps = [stage_stepper(op, carry, periodic=True)
             for op, carry in stages(state["phi"].dtype, mobility)]
    s = dict(state)
    for _ in range(n_steps):
        for stp in steps:
            s = stp(s)
    return s["phi"]


def bracket(state, target, n_steps, mobilities=MOBILITIES):
    """The mean squared misfit of φ against ``target`` by mobility."""
    return {m: torch.mean((trajectory(state, m, n_steps) - target) ** 2
                          ).item() for m in mobilities}


def main(argv=None):
    args, dev = parse(parser(__doc__.split("\n\n")[0]), argv)
    dh = record(initial_phi(device=dev))
    print(dh.graph.describe())
    run_replay, run_fused = compiled(dh)
    st = dh.state()
    with torch.no_grad():
        out_r = run_replay(st, K * CYCLES)
        out_f = run_fused(st, K * CYCLES)
    torch.testing.assert_close(out_f["phi"], out_r["phi"], rtol=1e-12,
                               atol=1e-12)
    m0, m1 = st["phi"].sum().item(), out_r["phi"].sum().item()
    print(f"mass conserved: {m0:.6f} -> {m1:.6f} (drift {abs(m1 - m0):.2e})")
    e0 = ginzburg_landau_energy(st["phi"]).item()
    e1 = ginzburg_landau_energy(out_r["phi"]).item()
    print(f"free energy descends: {e0:.3f} -> {e1:.3f}")
    assert e1 < e0
    print("FUSED == REPLAY, physics OK")
    # the misfit is least at the true mobility (1.0)
    with torch.no_grad():
        vals = bracket(st, out_r["phi"], K * CYCLES)
    print("misfit by mobility:", vals)
    assert vals[1.0] < vals[0.5] and vals[1.0] < vals[1.5]
    print("INVERSE PROBLEM OK")
    return {"energy": (e0, e1), "misfits": vals}


if __name__ == "__main__":
    main()
