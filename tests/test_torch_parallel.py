"""The port's halo exchange and ``ShardedStencil`` (``parallel/``) against
the JAX package's, in float64 on the CPU.

The port's meshes are ``["cpu"] * 8`` (one process drives every shard);
the JAX side runs ``ShardedStencil(..., lowering="jnp")`` on the 8 virtual
CPU devices of ``tests/conftest.py``.  Each sharded value is held against
the JAX package's sharded value and the port's unsharded op, to rtol
1e-12 (values) and 1e-11 (gradients), the JAX sharding tests' tolerances.
Mirrors ``tests/test_sharding.py`` and the ``ShardedStencil`` cases of
``tests/test_sharded_uneven.py``, plus the halo functions themselves and
the transport counts.  Inputs are made from a seed with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu import parallel as jpar
from pystencils_autodiff_tpu.models import \
    sharded_diffusion3d as jsharded_diffusion3d
from torch_jax_twin import jax_twin

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, fields
from pystencils_autodiff_tpu_torch.models import (anisotropic27_op,
                                                  diffusion3d_op,
                                                  elastic_velocity_op,
                                                  sharded_diffusion3d)
from pystencils_autodiff_tpu_torch.parallel import (
    ShardedArray, ShardedStencil, exchange_count, exchange_dim,
    extend_with_halo, make_mesh, mask_global_ghost, reset_exchange_count,
    shard_array)

RTOL, GRAD_RTOL = 1e-12, 1e-11
CPU8 = ["cpu"] * 8


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64,
                        requires_grad=grad)


def _close(got, ref, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def _jmesh(shape, axes):
    return jpar.make_mesh(shape, axes)


def lap_op():
    x, y = fields("x, y", 2)
    return AutoDiffOp([Assignment(
        y.center, x[1, 0] + x[-1, 0] + x[0, 1] + x[0, -1] - 4 * x[0, 0])],
        op_name="lap2d")


def varcoeff_op():
    x, y, k = fields("x, y, k", 2)
    return AutoDiffOp([Assignment(
        y.center, k[0, 0] * (x[1, 0] + x[-1, 0] - 2 * x[0, 0])
        + x[0, 1] ** 2)], op_name="vc")


def uneven_op():
    u, kap, out = fields("u, kap, out", 2)
    lap = u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1] - 4 * u[0, 0]
    return AutoDiffOp([Assignment(out.center,
                                  u.center + 0.1 * kap.center ** 2 * lap)],
                      op_name="heat_vk_uneven")


def _both(op, mesh_shape, axes, dims, **kw):
    """(port sharded, JAX sharded, port unsharded) of ``op``."""
    port = ShardedStencil(op, make_mesh(mesh_shape, axes, CPU8), dims, **kw)
    jop = jax_twin(op)
    jsh = jpar.ShardedStencil(jop, _jmesh(mesh_shape, axes), dims,
                              lowering="jnp", **kw)
    return port, jax.jit(jsh), op.torch_function()


# ---------------------------------------------------------------- mesh ----

def test_make_mesh_and_shard_array():
    """A mesh never repeats or invents devices on its own; a sharded array
    round-trips and reports its global shape."""
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        make_mesh((4, 2), ("x", "y"), ["cpu"] * 4)
    mesh = make_mesh((4, 2), ("x", "y"), CPU8)
    assert mesh.shape == {"x": 4, "y": 2} and mesh.size == 8
    a = _t(_rand(0, (8, 6, 3)))
    s = shard_array(a, mesh, ("x", "y"))
    assert s.shape == (8, 6, 3) and s.blocks[3].shape == (2, 3, 3)
    assert torch.equal(s.full(), a)
    with pytest.raises(ValueError, match="does not divide"):
        shard_array(_t(_rand(0, (9, 6))), mesh, ("x",))


# ---------------------------------------------------------------- halo ----

def test_exchange_dim_bounded_periodic_and_size1():
    """Halo slabs come from the neighbours; a bounded domain's edge shards
    receive zeros, a periodic one wraps; a size-1 axis moves nothing and
    counts no transport; one exchange is one transport a direction."""
    mesh = make_mesh((4, 1), ("x", "y"), CPU8)
    g = _t(_rand(1, (8, 5)))
    s = shard_array(g, mesh, ("x", "y"))
    for periodic in (False, True):
        reset_exchange_count()
        e = exchange_dim(s, 0, "x", 1, 2, periodic)
        assert exchange_count() == 2
        for i, b in enumerate(e.blocks):
            rows = [(2 * i + r) for r in range(-1, 4)]
            want = torch.stack([
                g[r % 8] if (periodic or 0 <= r < 8) else torch.zeros(5,
                                                              dtype=g.dtype)
                for r in rows])
            assert torch.equal(b, want), (periodic, i)
        reset_exchange_count()
        e1 = exchange_dim(s, 1, "y", 1, 1, periodic)
        assert exchange_count() == 0
        blk = s.blocks[0]
        want = (torch.cat([blk[:, -1:], blk, blk[:, :1]], 1) if periodic
                else torch.cat([torch.zeros(2, 1, dtype=g.dtype), blk,
                                torch.zeros(2, 1, dtype=g.dtype)], 1))
        assert torch.equal(e1.blocks[0], want)


def test_extend_with_halo_fills_corners_and_masks_global_ghost():
    """Ascending-dim exchanges carry the corner halos; the global-ghost
    mask zeroes exactly the global frame of the sharded dims."""
    mesh = make_mesh((2, 2), ("x", "y"), CPU8)
    g = _t(_rand(2, (8, 8)))
    s = shard_array(g, mesh, ("x", "y"))
    e = extend_with_halo(s, {0: "x", 1: "y"}, [(1, 1), (1, 1)], True)
    padded = torch.cat([g[-1:], g, g[:1]], 0)
    padded = torch.cat([padded[:, -1:], padded, padded[:, :1]], 1)
    for i, b in enumerate(e.blocks):
        cx, cy = divmod(i, 2)
        want = padded[4 * cx:4 * cx + 6, 4 * cy:4 * cy + 6]
        assert torch.equal(b, want), i
    m = mask_global_ghost(s, {0: "x", 1: "y"}, [(1, 1), (2, 0)], (8, 8))
    want = torch.zeros_like(g)
    want[1:7, 2:] = g[1:7, 2:]
    assert torch.equal(m.full(), want)
    assert mask_global_ghost(s, {0: "x"}, [(1, 1)], (8, 8),
                             periodic=True) is s


# ------------------------------------------------------- ShardedStencil ----

@pytest.mark.parametrize("mesh_shape,axes,dims,shape", [
    ((4,), ("x",), {0: "x"}, (64, 32)),
    ((4, 2), ("x", "y"), {0: "x", 1: "y"}, (32, 16)),
])
def test_decomposition_matches_single_device(mesh_shape, axes, dims, shape):
    """1D and 2D decompositions: equal to the JAX package's sharded op and
    to the port's op on the gathered array (a ShardedArray in, one out)."""
    op = lap_op()
    port, jsh, single = _both(op, mesh_shape, axes, dims)
    x = _rand(0, shape)
    xs = shard_array(_t(x), port.mesh, port.partition_spec(
        op.forward_input_fields[0]))
    out = port(xs)
    assert isinstance(out, ShardedArray)
    _close(out.full(), jsh(jnp.asarray(x)))
    _close(port(_t(x)), single(_t(x)))


def test_sharded_gradients_match_single_device():
    """The transposed exchange (reverse transport + edge accumulation)
    composes with the op's symbolic backward to the exact gradient."""
    op = lap_op()
    port, jsh, single = _both(op, (4,), ("x",), {0: "x"})
    x = _rand(2, (64, 32))
    xt = _t(x, True)
    (g,) = torch.autograd.grad(torch.sin(port(xt)).sum(), xt)
    jg = jax.jit(jax.grad(lambda a: jnp.sum(jnp.sin(jsh(a)))))(
        jnp.asarray(x))
    _close(g, jg, GRAD_RTOL)
    xs = _t(x, True)
    (gs,) = torch.autograd.grad(torch.sin(single(xs)).sum(), xs)
    _close(g, gs.detach(), GRAD_RTOL)


def test_sharded_varcoeff_gradients():
    op = varcoeff_op()
    port, jsh, _ = _both(op, (2, 2), ("x", "y"), {0: "x", 1: "y"})
    x, k = _rand(3, (16, 16)), _rand(4, (16, 16))
    xt, kt = _t(x, True), _t(k, True)
    grads = torch.autograd.grad(torch.cos(port(k=kt, x=xt)).sum(), (xt, kt))
    jg = jax.jit(jax.grad(lambda a, b: jnp.sum(jnp.cos(jsh(k=b, x=a))),
                          argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(k))
    for a, b in zip(grads, jg):
        _close(a, b, GRAD_RTOL)


def test_periodic_decomposition():
    """Periodic halos wrap: against a roll oracle and the JAX package."""
    x, y = fields("x, y", 2)
    op = AutoDiffOp([Assignment(y.center, x[1, 0] - x[-1, 0])], op_name="per")
    port, jsh, _ = _both(op, (4,), ("x",), {0: "x"}, periodic=True)
    xv = _rand(5, (32, 16))
    out = port(_t(xv))
    _close(out, np.roll(xv, -1, 0) - np.roll(xv, 1, 0))
    _close(out, jsh(jnp.asarray(xv)))


def test_config5_sharded_diffusion3d():
    """Config #5 at CPU scale: the 3D κ-diffusion op over a (2, 2) mesh,
    value and gradients, against the JAX package's
    ``sharded_diffusion3d`` and the port's unsharded op."""
    mesh = make_mesh((2, 2), ("x", "y"), CPU8)
    port = sharded_diffusion3d(mesh, dtype="float64")
    jsh = jax.jit(jsharded_diffusion3d(_jmesh((2, 2), ("x", "y")),
                                       dtype="float64"))
    u, k = _rand(6, (16, 16, 8)), 1 + 0.1 * _rand(7, (16, 16, 8)) ** 2
    ut, kt = _t(u, True), _t(k, True)
    out = port(u=ut, kappa=kt)
    _close(out, jsh(u=jnp.asarray(u), kappa=jnp.asarray(k)))
    single = diffusion3d_op(dtype="float64").torch_function()
    _close(out, single(u=_t(u), kappa=_t(k)))
    grads = torch.autograd.grad(out.square().sum(), (ut, kt))
    jg = jax.jit(jax.grad(lambda a, b: jnp.sum(jsh(u=a, kappa=b) ** 2),
                          argnums=(0, 1)))(jnp.asarray(u), jnp.asarray(k))
    for a, b in zip(grads, jg):
        _close(a, b, GRAD_RTOL)


def test_sharded_corner_halos_27point():
    """Diagonal offsets over a (2, 2, 2) mesh: later dims transport the
    earlier dims' halos (corner halos)."""
    op = anisotropic27_op(dtype="float64")
    port, jsh, single = _both(op, (2, 2, 2), ("x", "y", "z"),
                              {0: "x", 1: "y", 2: "z"})
    u = _rand(40, (8, 8, 8))
    ut = _t(u, True)
    out = port(ut)
    _close(out, jsh(jnp.asarray(u)))
    _close(out, single(_t(u)))
    (g,) = torch.autograd.grad(torch.sin(out).sum(), ut)
    jg = jax.jit(jax.grad(lambda a: jnp.sum(jnp.sin(jsh(a)))))(
        jnp.asarray(u))
    _close(g, jg, GRAD_RTOL)


def test_sharded_staggered_elastic():
    """A staggered multi-output op decomposed over a (2, 2) mesh."""
    op = elastic_velocity_op(dtype="float64")
    port, jsh, _ = _both(op, (2, 2), ("x", "y"), {0: "x", 1: "y"})
    args = {f.name: _rand(50 + i, (16, 16))
            for i, f in enumerate(op.forward_input_fields)}
    outs = port(**{n: _t(a) for n, a in args.items()})
    jouts = jsh(**{n: jnp.asarray(a) for n, a in args.items()})
    for a, b in zip(outs, jouts):
        _close(a, b)


@pytest.mark.parametrize("mesh_shape,axes,dims", [
    ((4,), ("x",), {0: "x"}),
    ((2, 2), ("x", "y"), {0: "x", 1: "y"}),
])
def test_overlap_mode_matches_exactly(mesh_shape, axes, dims):
    """overlap=True (bulk on the raw block, edge strips recomputed) is
    bit-equal to overlap=False, and equal to the single-device op and the
    JAX package's overlap mode, gradients included."""
    xo, yo, ko = fields("xo, yo, ko", 2)
    op = AutoDiffOp([Assignment(yo.center, ko[0, 0] * (
        xo[1, 0] + xo[-1, 0] - 2 * xo[0, 0]) + xo[0, 1] ** 2)],
        op_name="ovl")
    mesh = make_mesh(mesh_shape, axes, CPU8)
    plain = ShardedStencil(op, mesh, dims)
    ovl = ShardedStencil(op, mesh, dims, overlap=True)
    jovl = jax.jit(jpar.ShardedStencil(jax_twin(op), _jmesh(mesh_shape, axes),
                                       dims, lowering="jnp", overlap=True))
    x, k = _rand(80, (32, 16)), _rand(81, (32, 16))
    xt, kt = _t(x, True), _t(k, True)
    o = ovl(xo=xt, ko=kt)
    assert torch.equal(o, plain(xo=_t(x), ko=_t(k)))
    _close(o, op.torch_function()(xo=_t(x), ko=_t(k)))
    _close(o, jovl(xo=jnp.asarray(x), ko=jnp.asarray(k)))
    grads = torch.autograd.grad(torch.sin(o).sum(), (xt, kt))
    jg = jax.jit(jax.grad(lambda a, b: jnp.sum(jnp.sin(jovl(xo=a, ko=b))),
                          argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(k))
    for a, b in zip(grads, jg):
        _close(a, b, GRAD_RTOL)


def test_sharded_stencil_uneven_2d_and_gradients():
    """45×33 over a (4, 2) mesh: both dims pad-and-mask; value and the κ
    gradient equal the single-device op's and the JAX package's."""
    op = uneven_op()
    port, jsh, single = _both(op, (4, 2), ("x", "y"), {0: "x", 1: "y"})
    u, kap = _rand(0, (45, 33)), 1.0 + 0.1 * _rand(1, (45, 33)) ** 2
    tgt = _rand(4, (45, 33))
    kt = _t(kap, True)
    out = port(u=_t(u), kap=kt)
    assert out.shape == (45, 33)
    _close(out, single(u=_t(u), kap=_t(kap)))
    _close(out, jsh(u=jnp.asarray(u), kap=jnp.asarray(kap)))
    (g,) = torch.autograd.grad((out - _t(tgt)).square().sum(), kt)
    jg = jax.jit(jax.grad(lambda kk: jnp.sum(
        (jsh(u=jnp.asarray(u), kap=kk) - tgt) ** 2)))(jnp.asarray(kap))
    _close(g, jg, GRAD_RTOL)


def test_sharded_stencil_uneven_periodic_raises():
    op = uneven_op()
    port = ShardedStencil(op, make_mesh((4,), ("x",), CPU8), {0: "x"},
                          periodic=True)
    with pytest.raises(ValueError, match="divide the mesh evenly"):
        port(u=_t(_rand(0, (45, 32))), kap=_t(_rand(1, (45, 32))))


def test_sequential_stepping_costs_two_transports_a_step():
    """2 transports per sharded dim and step; the gradient adds their
    transposes."""
    op = lap_op()
    port = ShardedStencil(op, make_mesh((4,), ("x",), CPU8), {0: "x"})
    xt = _t(_rand(3, (64, 32)), True)
    reset_exchange_count()
    a = xt
    for _ in range(3):
        a = port(a)
    assert exchange_count() == 6
    torch.autograd.grad(a.sum(), xt)
    assert exchange_count() == 12
