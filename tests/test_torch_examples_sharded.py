"""The port's sharded examples (``sharded_diffusion.py``,
``elastic_simulation.py``) against the same flows written here with the
JAX package's API, in float64 on the CPU: the port on meshes of CPU
shards, the JAX package on the 8 virtual CPU devices of
``tests/conftest.py`` (its ``ShardedChain`` in interpret mode, as its
own tests run it), from inputs made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pystencils_autodiff_tpu import models as jmodels
from pystencils_autodiff_tpu import parallel as jpar
from pystencils_autodiff_tpu.datahandling import DataHandling as JDH
from pystencils_autodiff_tpu.simulation import Simulation as JSim
from torch_jax_twin import jax_twin
from chip_smoke import example_module as example

from pystencils_autodiff_tpu_torch.parallel import make_mesh


def _rng(seed):
    return np.random.default_rng(seed)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, ref, rtol, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


# ------------------------------------------------------- sharded examples --

def test_sharded_diffusion_matches_jax_and_single_device():
    """Forward and κ-gradient of the sharded op on a 2×4 mesh of the CPU
    against the JAX package's ShardedStencil on its 8 virtual devices
    (1e-12) and the port's unsharded op (1e-13); the fused chain (k=4,
    fused backward, dim 0 over "x") and its gradient against the JAX
    package's ShardedChain."""
    ex = example("sharded_diffusion")
    rng = _rng(5)
    u0 = rng.standard_normal(ex.SHAPE)
    kv = 1.0 + 0.1 * rng.standard_normal(ex.SHAPE) ** 2
    mesh = ex.mesh_of("cpu")
    y, y_ref, g, g_ref, _ = ex.stencil(torch.tensor(u0), torch.tensor(kv),
                                       mesh)
    _close(y.full(), y_ref, 1e-13, "forward vs unsharded")
    _close(g, g_ref, 1e-13, "gradient vs unsharded")

    op, hop = ex.heat_ops()
    jmesh = jpar.make_mesh((2, 4), ("x", "y"))
    jsh = jpar.ShardedStencil(jax_twin(op), jmesh, {0: "x", 1: "y"})
    ju, jk = jnp.asarray(u0), jnp.asarray(kv)
    jy, pull = jax.vjp(lambda kk: jsh(k=kk, u=ju), jk)
    _close(y.full(), jy, 1e-12, "forward vs JAX")
    _close(g, pull(jnp.cos(jy))[0], 1e-12, "gradient vs JAX")

    uc = rng.standard_normal((32, 16))
    out, gc = ex.chain(torch.tensor(uc), mesh)
    jch = jpar.ShardedChain(jax_twin(hop), k=ex.CHAIN_K, mesh=jmesh,
                            dim_axes={0: "x"}, carry_map={"u": "out"},
                            fused_bwd=True, interpret=True)
    jout, pull = jax.vjp(lambda a: jch({"u": a})["u"], jnp.asarray(uc))
    _close(out, jout, 1e-12, "chain state")
    _close(gc, pull(2 * jout)[0], 1e-12, "chain gradient")


def test_elastic_simulation_matches_jax_and_unsharded():
    """25 steps of the sharded Simulation on a 2×2 mesh of the CPU from
    seeded fields against the JAX package's sharded run on its virtual
    devices (1e-12) and the port's unsharded run (1e-13)."""
    ex = example("elastic_simulation")
    rng = _rng(6)
    shape = tuple(s + 2 for s in ex.DOMAIN)
    init = {n: 0.1 * rng.standard_normal(shape) for n in ex.ELASTIC}
    mesh = make_mesh((2, 2), ("x", "y"), devices=["cpu"] * 4)
    tinit = {n: torch.tensor(a) for n, a in init.items()}
    dh = ex.simulate("cpu", mesh, init=tinit)
    dh2 = ex.simulate("cpu", init=tinit)

    jmesh = jpar.make_mesh((2, 2), ("x", "y"))
    jd = JDH(ex.DOMAIN, mesh=jmesh, dim_axes={0: "x", 1: "y"},
             default_dtype=jnp.float64)
    for n in ex.ELASTIC:
        jd.add_field(n)
        jd.set_array(n, jnp.asarray(init[n]))
    js = JSim(jd)
    js.add_boundary_conditions({"vx": "neumann", "vy": "neumann"})
    js.add_sweep(jmodels.elastic_velocity_op(dtype="float64"),
                 {"vx": "vx_next", "vy": "vy_next"})
    js.add_sweep(jmodels.elastic_stress_op(dtype="float64"),
                 {"sxx": "sxx_next", "syy": "syy_next", "sxy": "sxy_next"})
    js.run(jd.state(), ex.STEPS)
    for n in ex.ELASTIC:
        got = ex.full(dh.arrays[n])
        _close(got, dh2.arrays[n], 1e-13, f"{n} vs unsharded")
        _close(got, jd.arrays[n], 1e-12, f"{n} vs JAX")
    assert ex.probes(mesh).keys() == {"P-divisibility", "P-empty"}
