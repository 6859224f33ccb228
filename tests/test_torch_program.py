"""The port's plain PyTorch lowering (``ops/torch_ref.py``) against the JAX
package's jnp lowering, in float64 on the CPU: every domain mode, index-dim
fields in AoS and SoA storage, accumulation outputs and the staged (TF_MAD)
backward.  Plus: the port imports and runs with jax blocked."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pystencils_autodiff_tpu.ops import common as jcommon
from pystencils_autodiff_tpu.ops.jnp_ref import make_jnp_stencil
from pystencils_autodiff_tpu.ops.vjp import make_staged_fn as jmake_staged_fn
from torch_jax_twin import jax_twin

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field, fields
from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                  heat_step3d_op, heat_step_op)
from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                               backward_programs,
                                               forward_program,
                                               make_cuda_stencil,
                                               make_torch_stencil)
from pystencils_autodiff_tpu_torch.ops.common import storage_shape
from pystencils_autodiff_tpu_torch.ops.vjp import make_staged_fn

RTOL = 1e-12
SHAPE2, SHAPE3 = (24, 20), (8, 10, 12)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vector_op(layout):
    """A small two-component op reading both components at offsets."""
    v = Field("v", 2, index_shape=(2,), layout=layout)
    w = Field("w", 2, index_shape=(2,), layout=layout)
    c = Field("c", 2)
    return AutoDiffOp([
        Assignment(w.center(0), v[1, 0](0) * c[0, 0] - v[0, -1](1)),
        Assignment(w.center(1), v[0, 1](0) * v[-1, 0](1) + c[0, 1]),
    ], op_name=f"vec_{layout}")


def _accum_op():
    x, y, k = fields("x, y, k", 2)
    return AutoDiffOp([Assignment(y.center, k[1, 0] * x[1, 0]
                                  + k[-1, 0] * x[-1, 0] * x[0, 0])],
                      op_name="accum", time_constant_fields=[k])


def _tfmad_op():
    x, y, k = fields("x, y, k", 2)
    return AutoDiffOp([Assignment(y.center, k[1, 0] * x[1, 0]
                                  + k[-1, 0] * x[-1, 0] * x[0, 0])],
                      op_name="tfmad", diff_mode="transposed-forward")


OPS = {
    "heat_kappa": lambda: heat_step_op(kappa_field=True, dtype="float64"),
    "diffusion3d": lambda: diffusion3d_op(dtype="float64"),
    "heat3d": lambda: heat_step3d_op(dtype="float64"),
    "vec_aos": lambda: _vector_op("aos"),
    "vec_soa": lambda: _vector_op("soa"),
    "accum": _accum_op,
}


def _spatial(op):
    return SHAPE3 if op.forward_input_fields[0].spatial_dimensions == 3 else SHAPE2


def _inputs(prog, spatial, seed=0):
    rng = np.random.default_rng(seed)
    return {f.name: rng.standard_normal(storage_shape(f, spatial))
            for f in prog.input_fields}


def _compare(port_fn, jax_fn, arrays):
    got = port_fn({n: torch.tensor(a) for n, a in arrays.items()})
    ref = jax_fn({n: jnp.asarray(a) for n, a in arrays.items()})
    assert set(got) == set(ref)
    for n in ref:
        r = np.asarray(ref[n])
        assert got[n].shape == r.shape, n
        scale = np.abs(r).max()
        np.testing.assert_allclose(got[n].numpy(), r, rtol=RTOL,
                                   atol=RTOL * scale, err_msg=n)


MODES = {
    "interior": {},
    "full": {"full_domain": True},
    "periodic": {"periodic": True},
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(OPS))
def test_forward_program_matches_jnp(name, mode):
    op = OPS[name]()
    kw = MODES[mode]
    _compare(make_torch_stencil(forward_program(op), **kw),
             make_jnp_stencil(jcommon.forward_program(jax_twin(op)), **kw),
             _inputs(forward_program(op), _spatial(op)))


@pytest.mark.parametrize("mode", ["masked_full", "interior", "periodic"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_backward_program_matches_jnp(name, mode):
    """Backward programs in the exact-VJP mode (full domain, cotangent
    masked to the forward interior), plus interior and periodic; for the
    accumulation op the previous-adjoint input is random, not zero."""
    op = OPS[name]()
    ghost = forward_program(op).ghost
    kw = {"masked_full": {"full_domain": True, "adjoint_mask_ghost": ghost},
          "interior": {}, "periodic": {"full_domain": True,
                                       "periodic": True}}[mode]
    bp = backward_program(op)
    _compare(make_torch_stencil(bp, **kw),
             make_jnp_stencil(jcommon.backward_program(jax_twin(op)), **kw),
             _inputs(bp, _spatial(op), seed=1))


@pytest.mark.parametrize("periodic", [False, True])
def test_staged_tfmad_backward_matches_jnp(periodic):
    op = _tfmad_op()
    progs = backward_programs(op)
    assert len(progs) == 2  # Jacobian stage + gather stage
    jprogs = jcommon.backward_programs(jax_twin(op))
    final = ({} if periodic
             else {"adjoint_mask_ghost": forward_program(op).ghost})
    kw = {"periodic": True} if periodic else {}
    inter = set(op.backward_assignments.intermediate_fields)
    fields_in = []
    for p in progs:
        fields_in += [f for f in p.input_fields
                      if f not in inter and f not in fields_in]
    rng = np.random.default_rng(2)
    arrays = {f.name: rng.standard_normal(SHAPE2) for f in fields_in}
    _compare(make_staged_fn(progs, make_torch_stencil, final, **kw),
             jmake_staged_fn(jprogs, make_jnp_stencil, final, **kw), arrays)


def test_program_structure_matches_jax_package():
    for name, make in OPS.items():
        op = make()
        jop = jax_twin(op)
        for port, ref in ((forward_program(op), jcommon.forward_program(jop)),
                          (backward_program(op),
                           jcommon.backward_program(jop))):
            assert port.input_names == ref.input_names, name
            assert port.output_names == ref.output_names, name
            assert port.ghost == ref.ghost, name
            assert ([str(s.target) for s in port.steps]
                    == [str(s.target) for s in ref.steps])
            assert ([f.name for f in port.accum_fields]
                    == [f.name for f in ref.accum_fields])


def test_dd_accumulation_is_not_ported():
    """(Named when the port refused it.)  A program of the JAX package
    compiled with extended-precision sums (``accumulate="dd"``) has its
    counterpart in the port, and both of the port's lowerings take it: the
    port's dd program carries the JAX-built program's mode and steps, the
    CUDA lowering builds its wrapper with the dd body in its source, and
    the plain version agrees with the JAX package's dd jnp lowering in
    every mode, forward and backward."""
    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
        generate_cuda_source
    from pystencils_autodiff_tpu_torch.models import anisotropic27_op

    op = anisotropic27_op(dtype="float64")
    jop = jax_twin(op)
    pairs = ((forward_program(op, "dd"),
              jcommon.forward_program(jop, accumulate="dd")),
             (backward_program(op, "dd"),
              jcommon.backward_program(jop, accumulate="dd")))
    rng = np.random.default_rng(3)
    for port, ref in pairs:
        assert port.accumulate == ref.accumulate == "dd"
        assert ([str(s.target) for s in port.steps]
                == [str(s.target) for s in ref.steps])
        assert make_cuda_stencil(port).program is port
        assert "psat::ddto<T>" in generate_cuda_source(port, "float64")
        arrays = {f.name: rng.standard_normal(SHAPE3)
                  for f in port.input_fields}
        for mode, kw in MODES.items():
            _compare(make_torch_stencil(port, **kw),
                     make_jnp_stencil(ref, **kw), arrays)


def test_port_runs_with_jax_blocked():
    """The port imports torch, sympy and numpy — never jax, and nothing of
    the JAX package ``pystencils_autodiff_tpu`` (a subprocess: this test
    process has both loaded already).  Every module of the port and
    ``chip_smoke`` import with both blocked, and the op, the FWI gradient,
    config #2's fused 3D chain, a 3D nonlinear op's fused value+gradient
    (the streaming kernel's route), a stage chain with an in-chain BC
    and its fused backward, the op through the tiled route, the recorded
    elastic graph replayed and as a stage chain, a kernel pair, config
    #5's sharded diffusion and a sharded chain on a CPU mesh run; the
    serving and utils modules import too; the bridges import, and the
    generated-C pair and ``torch_native`` run on CPU tensors; an
    ``accumulate="dd"`` op runs, and ``utils.dd`` and the probes of
    ``utils.probes`` on CPU tensors."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        BLOCKED = ("jax", "jaxlib", "pystencils_autodiff_tpu")
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import numpy as np, torch
        import pystencils_autodiff_tpu_torch as port
        mods = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                      port.__name__ + ".")]
        for m in mods + ["chip_smoke"]:
            importlib.import_module(m)
        assert len(mods) >= 20, mods
        app = ("compose", "datahandling", "graph_datahandling", "simulation",
               "models.burgers", "models._memo")
        assert all(port.__name__ + "." + m in mods for m in app), mods
        par = ("parallel", "parallel.chain", "parallel.halo",
               "parallel.mesh", "parallel.sharding", "ops.flatten")
        assert all(port.__name__ + "." + m in mods for m in par), mods
        srv = ("serving", "ops.custom_ops", "utils", "utils.autotune",
               "utils.benchmark", "utils.config", "utils.profiling")
        assert all(port.__name__ + "." + m in mods for m in srv), mods
        brg = ("backends", "backends._c_native", "backends._torch",
               "backends._tensorflow", "backends._tensorflow_native",
               "backends.astnodes", "codegen.c_printer", "codegen.jit")
        assert all(port.__name__ + "." + m in mods for m in brg), mods
        from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                          sharded_diffusion3d)
        from pystencils_autodiff_tpu_torch.ops.flatten import ShardSpec
        from pystencils_autodiff_tpu_torch.parallel import (
            ShardedChain, ShardedStencil, exchange_dim, extend_with_halo,
            make_mesh, mask_global_ghost, shard_array)
        mesh = make_mesh((2, 2), ("x", "y"), ["cpu"] * 4)
        rng0 = np.random.default_rng(1)
        u5 = torch.tensor(rng0.standard_normal((8, 6, 5)),
                          requires_grad=True)
        k5 = torch.tensor(1 + 0.1 * rng0.random((8, 6, 5)))
        o5 = sharded_diffusion3d(mesh, dtype="float64")(u=u5, kappa=k5)
        (g5,) = torch.autograd.grad(o5.square().sum(), u5)
        assert o5.shape == (8, 6, 5) and torch.isfinite(g5).all()
        sh = ShardedChain(diffusion3d_op(dt=0.05, dtype="float64"), 2, mesh,
                          {0: "x", 1: "y"}, carry_map={"u": "u_next"},
                          fused_bwd=True)
        s5 = sh({"u": u5, "kappa": shard_array(k5, mesh, ("x", "y"))})
        assert type(s5["u"]).__name__ == "ShardedArray"
        assert ShardSpec((8, 6, 5), (0, 1)).sharded_dims == (0, 1)
        from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                          fwi_gradient,
                                                          heat_step_op)
        from pystencils_autodiff_tpu_torch.ops import (fused_chain_vjp,
                                                       fused_time_chain)
        f = heat_step_op(kappa_field=True).torch_function()
        rng = np.random.default_rng(0)
        u = torch.tensor(rng.standard_normal((12, 10)), requires_grad=True)
        k = torch.tensor(rng.standard_normal((12, 10)), requires_grad=True)
        out = f(u=u, kappa=k)
        out.square().sum().backward()
        assert out.shape == (12, 10) and u.grad.shape == (12, 10)
        assert torch.isfinite(k.grad).all() and k.grad.abs().sum() > 0
        c = 2.0 + torch.rand((12, 10), dtype=torch.float64)
        u0 = 0.1 * torch.randn((12, 10), dtype=torch.float64)
        obs = torch.zeros((4, 10), dtype=torch.float64)
        v, g = fwi_gradient(c, u0, obs, 5, 4, dt=0.2, fused_k=2)
        assert g.shape == (12, 10) and torch.isfinite(g).all() and v > 0
        chain = fused_time_chain(diffusion3d_op(dt=0.05, dtype="float64"), 2,
                                 {"u": "u_next"}, fused_bwd=True)
        kap = (1.0 + 0.1 * torch.rand((6, 5, 8), dtype=torch.float64)
               ).requires_grad_()
        st = chain({"u": torch.randn((6, 5, 8), dtype=torch.float64),
                    "kappa": kap})
        (gk,) = torch.autograd.grad(st["u"].square().sum(), kap)
        assert torch.isfinite(gk).all() and gk.abs().sum() > 0
        from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field
        u3, o3 = Field("u", 3, dtype="float64"), Field("u_next", 3,
                                                       dtype="float64")
        nl3d = AutoDiffOp([Assignment(o3.center, u3.center + 0.1 * (
            u3.neighbor(0, 1) * u3.center - u3.neighbor(2, -1)))],
            op_name="nl3d")
        g3 = fused_chain_vjp(nl3d, 2, {"u": "u_next"}, periodic=True)
        assert g3.route == "plane_two_phase"
        u3t = torch.randn((6, 5, 8), dtype=torch.float64)
        s3, c3 = g3({"u": u3t}, {"u": torch.ones_like(u3t)})
        assert torch.isfinite(c3["u"]).all() and c3["u"].abs().sum() > 0
        from pystencils_autodiff_tpu_torch.models import elastic_stages
        from pystencils_autodiff_tpu_torch.ops import fused_stage_chain
        sch = fused_stage_chain(elastic_stages(dtype="float64"), 2,
                                fused_bwd=True,
                                boundary={0: {"vx": ("sponge", "damp")}})
        st = {n: torch.randn((10, 9), dtype=torch.float64,
                             requires_grad=True)
              for n in ("vx", "vy", "sxx", "syy", "sxy")}
        out = sch({**st, "damp": torch.full((10, 9), 0.9,
                                            dtype=torch.float64)})
        (gs,) = torch.autograd.grad(out["vx"].square().sum(), st["sxx"])
        assert torch.isfinite(gs).all() and gs.abs().sum() > 0
        from pystencils_autodiff_tpu_torch.ops import row_tiled
        assert row_tiled.slab_tile(((1, 1),) * 2, 3, 4, (64, 64)).tile[0] == 4
        ft = heat_step_op(kappa_field=True).torch_function(strategy="tiled",
                                                           tile_rows=4)
        ut = u.detach().clone().requires_grad_()
        kt = k.detach().clone().requires_grad_()
        ot = ft(u=ut, kappa=kt)
        ot.square().sum().backward()
        u.grad, k.grad = None, None
        oc = f(u=u, kappa=k)
        oc.square().sum().backward()
        assert torch.allclose(ot, oc) and torch.allclose(ut.grad, u.grad)
        assert torch.allclose(kt.grad, k.grad)
        from pystencils_autodiff_tpu_torch.graph_datahandling import \
            GraphDataHandling
        from pystencils_autodiff_tpu_torch.models import burgers2d_op
        gdh = GraphDataHandling((8, 7), default_dtype=torch.float64,
                                device="cpu")
        for n in ("vx", "vy", "sxx", "syy", "sxy"):
            gdh.add_field(n, init=torch.randn((10, 9), dtype=torch.float64))
        damp = torch.full((10, 9), 0.9, dtype=torch.float64)
        with gdh.timeloop() as loop:
            loop.boundary({n: ("sponge", damp) for n in gdh.fields})
            for op, carry in elastic_stages(dtype="float64"):
                loop.sweep(op, carry)
        for fuse in ("none", "stages"):
            kw = {"k": 2, "fused_bwd": True} if fuse == "stages" else {}
            st = gdh.compile(fuse=fuse, **kw)(gdh.state(), 2)
            assert torch.isfinite(st["vx"]).all() and st["vx"].abs().sum() > 0
        pair = burgers2d_op().kernel_pair()
        ub = torch.randn((9, 8), dtype=torch.float64)
        assert pair(u=ub, v=ub)[0].shape == (9, 8)
        hop = heat_step_op(kappa_field=True, dtype="float64")
        cpair = hop.create_native_op()
        un, kn = u.detach().numpy(), k.detach().numpy()
        cn = cpair.forward(u=un, kappa=kn)["u_next"]
        cg = cpair.backward({"u_next": np.ones_like(un)},
                            {"u": un, "kappa": kn})
        fn_native = hop.create_pytorch_op(backend="torch_native")
        assert fn_native.pair.is_extension
        un_t = u.detach().clone().requires_grad_()
        on = fn_native(u=un_t, kappa=k.detach())
        (gn,) = torch.autograd.grad(on.sum(), un_t)
        ot = hop.torch_function()(u=u.detach(), kappa=k.detach())
        assert torch.allclose(on, ot) and np.allclose(cn, ot.numpy())
        assert np.allclose(cg["u"], gn.numpy())
        assert all(port.__name__ + "." + m in mods
                   for m in ("utils.dd", "utils.probes")), mods
        from pystencils_autodiff_tpu_torch.models import anisotropic27_op
        from pystencils_autodiff_tpu_torch.utils import dd as pdd, probes
        ua = torch.randn((6, 5, 7), requires_grad=True)
        ya = anisotropic27_op().torch_function(accumulate="dd")(ua)
        (ga,) = torch.autograd.grad(ya.square().sum(), ua)
        assert ya.dtype == torch.float32 and torch.isfinite(ga).all()
        s_, e_ = pdd.two_sum(torch.tensor(1.0), torch.tensor(1e-9))
        assert s_.item() == 1.0 and e_.item() != 0
        xp = probes.fma_rate(rows=8, cols=32, reps=3, device="cpu")
        lad = probes.op_ladder(reps=3, x=probes.ladder_input(
            64, 32, device="cpu"))
        assert xp.shape == (8, 32) and set(lad) == set(probes.RUNGS)
        assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
