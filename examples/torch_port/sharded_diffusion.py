"""Sharded 2D diffusion over a 2×4 mesh of eight shards of one device: the
gradient of a loss with respect to the conductivity through the sharded
op, then a comm-avoiding fused chain with its fused backward (the port of
``examples/sharded_diffusion.py``).

    python examples/torch_port/sharded_diffusion.py [--device cpu]

One process drives every shard; the mesh names the device eight times.
On CUDA tensors each shard's step launches the window kernel; the chain
runs the kernels' shard modes, and the script prints their launches by
PERF.md's rows: 12s and 13s (the stage march forward and its two-phase
backward), 7s and 9s (the time chain's forward and the streaming
two-phase)."""

import torch

from port_cli import parse, parser, seeded

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, fields
from pystencils_autodiff_tpu_torch.parallel import (ShardedChain,
                                                    ShardedStencil, make_mesh,
                                                    shard_array)

SHAPE, MESH, CHAIN_K = (64, 128), (2, 4), 4
F64 = torch.float64


def heat_ops():
    """(κ-heat op, constant-coefficient heat op) over fields u, out, k."""
    u, out, k = fields("u, out, k", 2)
    lap = u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1] - 4 * u[0, 0]
    op = AutoDiffOp([Assignment(out.center, u[0, 0] + 0.1 * k[0, 0] * lap)],
                    op_name="heat")
    hop = AutoDiffOp([Assignment(out.center, u[0, 0] + 0.1 * lap)],
                     op_name="heat_c")
    return op, hop


def inputs(shape=SHAPE, device="cpu"):
    """(u0, κ): u0 ~ N(0, 1), κ = 1 + 0.1·N(0, 1)², float64."""
    u0 = torch.randn(shape, generator=seeded(0), dtype=F64)
    kv = 1.0 + 0.1 * torch.randn(shape, generator=seeded(1), dtype=F64) ** 2
    return u0.to(device), kv.to(device)


def single_steps():
    """(op, spatial shape, float type, periodic, differentiated) of every
    single step this example launches: a card run may build their
    libraries before it starts."""
    op, _ = heat_ops()
    # the single-device op, and every shard's block with its halo
    block = tuple(n // a + 2 for n, a in zip(SHAPE, MESH))
    return [(op, shape, F64, False, True) for shape in (SHAPE, block)]


def mesh_of(device, shape=MESH):
    n = shape[0] * shape[1]
    return make_mesh(shape, ("x", "y"), devices=[torch.device(device)] * n)


def stencil(u0, kv, mesh):
    """The sharded op against the single-device one: (sharded output on
    ShardedArrays, single output, κ-gradient of Σ sin(out) sharded and
    single, (∂/∂κ, ∂/∂u) of Σ out² sharded)."""
    op, _ = heat_ops()
    sh = ShardedStencil(op, mesh, {0: "x", 1: "y"})
    f = {fl.name: fl for fl in op.forward_input_fields}
    us = shard_array(u0, mesh, sh.partition_spec(f["u"]))
    ks = shard_array(kv, mesh, sh.partition_spec(f["k"]))
    single = op.torch_function()
    with torch.no_grad():
        y = sh(k=ks, u=us)
        y_ref = single(k=kv, u=u0)
    kk = kv.clone().requires_grad_()
    (g,) = torch.autograd.grad(torch.sin(sh(k=kk, u=u0)).sum(), kk)
    kk = kv.clone().requires_grad_()
    (g_ref,) = torch.autograd.grad(torch.sin(single(k=kk, u=u0)).sum(), kk)
    kk, uu = kv.clone().requires_grad_(), u0.clone().requires_grad_()
    gk, gu = torch.autograd.grad(sh(k=kk, u=uu).square().sum(), (kk, uu))
    return y, y_ref, g, g_ref, (gk, gu)


def probes(mesh):
    """The sharded op's refusals: a mesh axis it lacks, a dim out of
    range."""
    op, _ = heat_ops()
    got = {}
    for name, dims in (("P-axis", {0: "nope"}), ("P-dim", {5: "x"})):
        try:
            ShardedStencil(op, mesh, dims)
        except ValueError as e:
            got[name] = str(e)
    return got


def shard_modes():
    """Launches of each shard mode so far, by row, from the counters of
    the kernels' wrappers (their keys' design names the mode)."""
    from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    rows = dict.fromkeys(("12s", "13s", "7s", "9s"), 0)
    for mod, design, row in ((sc, "march-shard", "12s"),
                             (sa, "march-shard", "13s"),
                             (tc, "march-shard", "7s"),
                             (pa, "forward_shard", "7s"),
                             (pa, "two_phase_shard", "9s")):
        rows[row] += sum(n for key, n in mod.LAUNCH_CALLS.items()
                         if key[5] == design)
    return rows


def chain(u0, mesh, k=CHAIN_K):
    """The constant-coefficient heat as a ``ShardedChain`` over dim 0 (the
    mesh's "x" axis), k steps a call, fused backward: (u after one call,
    the gradient of Σ u² w.r.t. u0)."""
    _, hop = heat_ops()
    ch = ShardedChain(hop, k=k, mesh=mesh, dim_axes={0: "x"},
                      carry_map={"u": "out"}, fused_bwd=True)
    ua = u0.clone().requires_grad_()
    out = ch({"u": ua})["u"]
    (gc,) = torch.autograd.grad(out.square().sum(), ua)
    return out.detach(), gc


def main(argv=None):
    args, dev = parse(parser(__doc__.split("\n\n")[0]), argv)
    mesh = mesh_of(dev)
    print("mesh:", mesh)
    u0, kv = inputs(device=dev)
    y, y_ref, g, g_ref, (gk, gu) = stencil(u0, kv, mesh)
    print("out sharding:", y.spec, "blocks", tuple(y.blocks[0].shape))
    fwd_err = (y.full() - y_ref).abs().max().item()
    grad_err = (g - g_ref).abs().max().item()
    print("fwd max err vs single-device:", fwd_err)
    print("grad max err vs single-device:", grad_err)
    print("sharded grad of both inputs ok:", tuple(gk.shape), tuple(gu.shape))
    assert fwd_err < 1e-13 and grad_err < 1e-13
    got = probes(mesh)
    for name, msg in got.items():
        print(f"{name}:", msg)
    assert sorted(got) == ["P-axis", "P-dim"], got
    before = shard_modes()
    out, gc = chain(u0, mesh)
    print("fused-chain fused-backward grad:", tuple(gc.shape),
          "finite:", bool(torch.isfinite(gc).all()))
    if dev.type == "cuda":
        modes = {row: n - before[row] for row, n in shard_modes().items()}
        print("shard-mode launches of the chain by row:", modes)
    assert torch.isfinite(out).all() and torch.isfinite(gc).all()
    return {"fwd_err": fwd_err, "grad_err": grad_err}


if __name__ == "__main__":
    main()
