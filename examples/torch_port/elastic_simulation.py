"""A sharded elastic simulation assembled from DataHandling and Simulation
(the app-assembly layer) on a 2×2 mesh of four shards of one device, held
against its unsharded replica (the port of
``examples/elastic_simulation.py``).

    python examples/torch_port/elastic_simulation.py [--device cpu]

On CUDA tensors each shard's sweep launches the window kernel."""

import torch

from port_cli import parse, parser

from pystencils_autodiff_tpu_torch.datahandling import DataHandling
from pystencils_autodiff_tpu_torch.models.elastic import (elastic_stress_op,
                                                          elastic_velocity_op)
from pystencils_autodiff_tpu_torch.parallel import ShardedArray, make_mesh
from pystencils_autodiff_tpu_torch.simulation import Simulation

DOMAIN, MESH, STEPS = (30, 30), (2, 2), 25
ELASTIC = ("vx", "vy", "sxx", "syy", "sxy")


def sweeps():
    """The velocity and stress sweeps as (op, carry) pairs, float64."""
    return [(elastic_velocity_op(dtype="float64"),
             {"vx": "vx_next", "vy": "vy_next"}),
            (elastic_stress_op(dtype="float64"),
             {"sxx": "sxx_next", "syy": "syy_next", "sxy": "sxy_next"})]


def single_steps():
    """(op, spatial shape, float type, periodic, differentiated) of every
    single step this example launches: a card run may build their
    libraries before it starts."""
    # the fields with their ghost frame, whole and in the mesh's blocks
    # (a halo around each)
    whole = tuple(n + 2 for n in DOMAIN)
    block = tuple(n // a + 2 for n, a in zip(whole, MESH))
    return [(op, shape, torch.float64, False, False)
            for shape in (whole, block) for op, _ in sweeps()]


def full(a):
    """The global tensor of a field (gathered where it is sharded)."""
    return a.full() if isinstance(a, ShardedArray) else a


def simulate(device, mesh=None, steps=STEPS, domain=DOMAIN, init=None):
    """The datahandling after ``steps`` velocity/stress steps with Neumann
    velocities, on ``mesh`` (dims 0, 1 over its axes x, y) or unsharded,
    from ``init`` (name -> global array, ghost frame included) or from a
    unit σxx source at (16, 16)."""
    kw = dict(mesh=mesh, dim_axes={0: "x", 1: "y"}) if mesh else {}
    dh = DataHandling(domain, default_dtype=torch.float64, device=device,
                      **kw)
    for n in ELASTIC:
        dh.add_field(n)
    if init is None:
        sxx = full(dh["sxx"]).clone()
        sxx[16, 16] = 1.0
        init = {"sxx": sxx}
    for n, a in init.items():
        dh.set_array(n, a)
    sim = Simulation(dh)
    sim.add_boundary_conditions({"vx": "neumann", "vy": "neumann"})
    for op, carry in sweeps():
        sim.add_sweep(op, carry)
    with torch.no_grad():
        sim.run(dh.state(), steps)
    return dh


def probes(mesh):
    """The refusals: a global extent the mesh axis does not divide, and a
    simulation with no sweeps."""
    got = {}
    try:
        bad = DataHandling((33, 30), mesh=mesh, dim_axes={0: "x", 1: "y"})
        bad.add_field("u")
    except ValueError as e:
        got["P-divisibility"] = str(e)[:95]
    try:
        Simulation().step_fn()
    except ValueError as e:
        got["P-empty"] = str(e)
    return got


def main(argv=None):
    args, dev = parse(parser(__doc__.split("\n\n")[0]), argv)
    mesh = make_mesh(MESH, ("x", "y"), devices=[dev] * 4)
    dh = simulate(dev, mesh)
    energy = sum(full(a).square().sum() for a in dh.arrays.values()).item()
    print("sharded elastic after", STEPS, "steps: vx sharding =",
          dh["vx"].spec, " energy =", energy)
    dh2 = simulate(dev)  # the unsharded replica must agree exactly
    err = max((full(dh.arrays[n]) - dh2.arrays[n]).abs().max().item()
              for n in dh.arrays)
    print("max sharded-vs-single err over all fields:", err)
    assert err < 1e-13
    print("SHARDED SIM OK")
    got = probes(mesh)
    for name, msg in got.items():
        print(f"{name}:", msg)
    assert sorted(got) == ["P-divisibility", "P-empty"], got
    return {"energy": energy, "err": err}


if __name__ == "__main__":
    main()
