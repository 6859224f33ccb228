"""The port's top-level API against the JAX package's, in float64 on the
CPU: the exports, operator composition (``compose_ops``, ``fuse_sweeps``),
the array ⇄ field helpers, the Burgers and 3D Laplacian models,
``memoize_model``, ``AutoDiffKernelPair`` and ``create_pytorch_op``.  The
JAX side runs ``lowering="jnp"``; ops built with the port reach it through
``torch_jax_twin.jax_twin``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystencils_autodiff_tpu as jpkg
from pystencils_autodiff_tpu import compose as jcompose
from pystencils_autodiff_tpu import field_tensor_conversion as jftc
from pystencils_autodiff_tpu.models import _memo as jmemo
from torch_jax_twin import jax_twin

import pystencils_autodiff_tpu_torch as port
from pystencils_autodiff_tpu_torch import (ArrayWrapper, Assignment,
                                           AutoDiffKernelPair, AutoDiffOp,
                                           Field, coerce_to_field,
                                           compose_ops,
                                           create_field_from_array_like,
                                           fields, fuse_sweeps)
from pystencils_autodiff_tpu_torch.assignment import AssignmentCollection
from pystencils_autodiff_tpu_torch.field_tensor_conversion import (
    to_numpy, torch_tensor_from_field)
from pystencils_autodiff_tpu_torch.models import (burgers2d_op,
                                                  elastic_stress_op,
                                                  elastic_velocity_op,
                                                  heat_step_op,
                                                  laplacian3d_op)
from pystencils_autodiff_tpu_torch.models._memo import memoize_model
from pystencils_autodiff_tpu_torch.ops import (backward_programs,
                                               forward_program)

RTOL = 1e-10
SHAPE2, SHAPE3 = (24, 20), (8, 10, 12)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-300))


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


# --------------------------------------------------------------- exports --

def test_exports_cover_the_jax_package():
    """The JAX package's 17 top-level names, plus ``from_jax_arrays``."""
    assert len(jpkg.__all__) == 17
    assert set(port.__all__) == set(jpkg.__all__) | {"from_jax_arrays"}
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    assert port.FieldType is port.field.FieldType
    assert port.AdjointField is port.adjoint_field.AdjointField
    x, y = fields("x, y", 2)
    jac = port.get_jacobian_of_assignments(
        [Assignment(y.center, x[1, 0] * x[0, 0])], [x[1, 0], x[0, 0]])
    assert jac.shape == (1, 2) and jac[0, 0] == x[0, 0]


# ------------------------------------------------------------ composition --

def _heat_after(op, name, dt=0.1):
    """A second heat step reading ``op``'s output ``u_next``."""
    un = fields("u_next", 2)
    lap = un[1, 0] + un[-1, 0] + un[0, 1] + un[0, -1] - 4 * un[0, 0]
    return AutoDiffOp([Assignment(fields(f"{name}_out", 2).center,
                                  un[0, 0] + dt * lap)], op_name=name)


def _value_and_grad(op, ins, weight):
    """Port (plain version on the CPU) and JAX values of the op and the
    gradient of ``sum(sin(out) * weight)`` over every output."""
    names = [f.name for f in op.forward_input_fields]
    ts = [_t(ins[n], True) for n in names]
    outs = _tuple(op.torch_function()(*ts))
    loss = sum((torch.sin(o) * _t(weight)).sum() for o in outs)
    grads = torch.autograd.grad(loss, ts)
    jf = jax_twin(op).jax_function(lowering="jnp")

    def jloss(*a):
        return sum(jnp.sum(jnp.sin(o) * weight) for o in _tuple(jf(*a)))

    jargs = [jnp.asarray(ins[n]) for n in names]
    j_outs = _tuple(jf(*jargs))
    j_grads = jax.grad(jloss, argnums=tuple(range(len(names))))(*jargs)
    return ([o.detach().numpy() for o in outs], [g.numpy() for g in grads],
            [np.asarray(o) for o in j_outs], [np.asarray(g) for g in j_grads])


def test_compose_two_heat_steps_matches_jax():
    op = heat_step_op(dt=0.1, dtype="float64")
    op2 = _heat_after(op, "h2b")
    fused = compose_ops(op, op2)
    j_fused = jcompose.compose_ops(jax_twin(op), jax_twin(op2))
    assert [f.name for f in fused.forward_input_fields] == ["u"]
    assert fused.op_name == j_fused.op_name == "heat_step2d_then_h2b"
    # ghost layers compose: 1 + 1 = 2 per side
    assert forward_program(fused).ghost == ((2, 2), (2, 2))
    x = _rand(0, (20, 20))
    w = np.zeros_like(x)
    w[4:-4, 4:-4] = 1.0
    outs, grads, j_outs, j_grads = _value_and_grad(fused, {"u": x}, w)
    for a, b in zip(outs + grads, j_outs + j_grads):
        _close(a, b)
    # agrees with the sequential steps on the doubly-shrunk interior, and
    # so does its gradient on an interior-supported loss
    f1, f2 = op.torch_function(), op2.torch_function()
    xt = _t(x, True)
    seq = f2(f1(xt))
    _close(outs[0][2:-2, 2:-2], seq.detach().numpy()[2:-2, 2:-2])
    (g_seq,) = torch.autograd.grad((torch.sin(seq) * _t(w)).sum(), xt)
    _close(grads[0], g_seq.numpy())


def _stress_on_next():
    """The stress op rewired to read the velocity op's outputs."""
    sop = elastic_stress_op(dtype="float64")
    vxn = Field("vx_next", 2, dtype="float64", origin=(0.5, 0.0))
    vyn = Field("vy_next", 2, dtype="float64", origin=(0.0, 0.5))
    sub = {}
    for a in sop.forward_assignments.main_assignments:
        for acc in a.rhs.atoms(Field.Access):
            if acc.field.name in ("vx", "vy"):
                sub[acc] = Field.Access(vxn if acc.field.name == "vx"
                                        else vyn, acc.offsets, acc.index)
    return AutoDiffOp(AssignmentCollection(
        [Assignment(a.lhs, a.rhs.xreplace(sub))
         for a in sop.forward_assignments.main_assignments]),
        op_name="stress_on_next")


def test_compose_elastic_velocity_into_stress_matches_jax():
    vop, sop2 = elastic_velocity_op(dtype="float64"), _stress_on_next()
    fused = compose_ops(vop, sop2, op_name="elastic_full_step")
    ins = {f.name for f in fused.forward_input_fields}
    assert ins == {"vx", "vy", "sxx", "syy", "sxy"}
    assert {f.name for f in fused.forward_output_fields} == {
        "sxx_next", "syy_next", "sxy_next"}
    args = {n: _rand(10 + i, (18, 18)) for i, n in enumerate(sorted(ins))}
    outs, grads, j_outs, j_grads = _value_and_grad(fused, args,
                                                   np.ones((18, 18)))
    for a, b in zip(outs + grads, j_outs + j_grads):
        _close(a, b)
    # the sequential pair on the deep interior
    vx_n, vy_n = vop.torch_function()(**{n: _t(args[n]) for n in
                                         ("sxx", "sxy", "vx", "syy", "vy")})
    seq = sop2.torch_function()(vx_next=vx_n, vy_next=vy_n,
                                **{n: _t(args[n]) for n in
                                   ("sxx", "syy", "sxy")})
    by_name = dict(zip([f.name for f in fused.forward_output_fields], outs))
    for f, s in zip(sop2.forward_output_fields, seq):
        _close(by_name[f.name][2:-2, 2:-2], s.numpy()[2:-2, 2:-2])


def test_fuse_sweeps_three_steps_matches_jax():
    u = fields("u", 1)
    mids = fields("m1, m2, m3", 1)
    ops, prev = [], u
    for i, m in enumerate(mids):
        ops.append(AutoDiffOp(
            [Assignment(m.center, prev[1] - 2 * prev[0] + prev[-1])],
            op_name=f"s{i}"))
        prev = m
    fused = fuse_sweeps(ops, op_name="tri")
    assert fused.op_name == "tri"
    assert [f.name for f in fused.forward_input_fields] == ["u"]
    assert forward_program(fused).ghost == ((3, 3),)
    j_fused = jcompose.fuse_sweeps([jax_twin(o) for o in ops], op_name="tri")
    x = _rand(3, (16,))
    fus = fused.torch_function()(_t(x)).numpy()
    _close(fus, np.asarray(j_fused.jax_function(lowering="jnp")(
        jnp.asarray(x))))
    seq = _t(x)
    for o in ops:
        seq = o.torch_function()(seq)
    _close(fus[3:-3], seq.numpy()[3:-3])


def test_fuse_sweeps_of_one_op_leaves_it_alone():
    """One op and a name give a fresh op; the (memoised) model op keeps its
    name — the JAX package renames the caller's op there."""
    op = heat_step_op(dt=0.1, dtype="float64")
    fused = fuse_sweeps([op], op_name="renamed")
    assert fused is not op and fused.op_name == "renamed"
    assert op.op_name == "heat_step2d"
    assert heat_step_op(dt=0.1, dtype="float64").op_name == "heat_step2d"
    assert fuse_sweeps([op]) is op
    with pytest.raises(ValueError, match="no ops"):
        fuse_sweeps([])


def test_compose_rejects_index_component_outputs():
    v = Field("v", 2, index_shape=(2,))
    w = fields("w", 2)
    op1 = AutoDiffOp([Assignment(v.center(0), w[1, 0]),
                      Assignment(v.center(1), w[0, 1])], op_name="vec")
    op2 = AutoDiffOp([Assignment(fields("z", 2).center, v[0, 0](0))],
                     op_name="z")
    with pytest.raises(NotImplementedError, match="index-component"):
        compose_ops(op1, op2)


# ------------------------------------------------------------ field helpers --

@pytest.mark.parametrize("dtype,declared", [
    (torch.float64, np.float64), (torch.float32, np.float32),
    (torch.bfloat16, np.float32), (torch.int32, np.int32)])
def test_field_from_tensor(dtype, declared):
    t = torch.zeros(6, 7, 3, dtype=dtype)
    f = create_field_from_array_like("h", t, index_dimensions=1)
    assert f.dtype == declared and f.index_shape == (3,)
    assert f.spatial_dimensions == 2


def test_field_helpers_match_jax():
    a = np.zeros((4, 5, 3), np.float32)
    for index_dims in (0, 1):
        f = create_field_from_array_like("g", a, index_dimensions=index_dims)
        jf = jftc.create_field_from_array_like("g", a,
                                               index_dimensions=index_dims)
        assert (f.spatial_dimensions, f.index_shape, f.dtype) == (
            jf.spatial_dimensions, jf.index_shape, jf.dtype)
    w = ArrayWrapper(np.zeros((4, 4, 2)), index_dimensions=1)
    assert create_field_from_array_like("w", w).index_shape == (2,)
    assert coerce_to_field("w", w).index_shape == (2,)
    f = fields("f", 2)
    assert coerce_to_field("f", f) is f
    assert port.is_array_like(a) and port.is_array_like(w)
    assert not port.is_array_like(f) and not port.is_array_like(3.0)
    with pytest.raises(TypeError):
        coerce_to_field("bad", object())
    with pytest.raises(ValueError, match="too small"):
        create_field_from_array_like("x", np.zeros(3), index_dimensions=1)


def test_torch_tensor_from_field_and_back():
    f = create_field_from_array_like("h", torch.zeros(6, 7,
                                                      dtype=torch.float64))
    t = torch_tensor_from_field(f, (6, 7), requires_grad=True, device="cpu")
    assert t.requires_grad and tuple(t.shape) == (6, 7)
    assert t.dtype == torch.float64 and t.device.type == "cpu"
    assert to_numpy(t).shape == (6, 7)
    assert to_numpy(torch.ones(2, dtype=torch.bfloat16)).dtype == np.float32
    soa = Field("f", 2, index_shape=(9,), layout="soa")
    assert tuple(torch_tensor_from_field(soa, (4, 5), device="cpu").shape) \
        == (9, 4, 5)
    if not torch.cuda.is_available():
        # the default device is the card: no quiet fall-back to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            torch_tensor_from_field(f, (6, 7))


# -------------------------------------------------------------------- models --

MODELS = {
    "burgers2d": (lambda: burgers2d_op(), SHAPE2,
                  lambda: jpkg.models.burgers2d_op()),
    "laplacian3d": (lambda: laplacian3d_op(dtype="float64"), SHAPE3,
                    lambda: jpkg.models.laplacian3d_op(dtype="float64")),
}


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_value_and_gradient_match_jax(name, periodic):
    """The port's model against the JAX package's own constructor."""
    make, shape, make_jax = MODELS[name]
    op, jop = make(), make_jax()
    assert op is make() and op.op_name == jop.op_name
    names = [f.name for f in op.forward_input_fields]
    assert names == [f.name for f in jop.forward_input_fields]
    rng = np.random.default_rng(5)
    ins = [rng.standard_normal(shape) for _ in names]
    cots = [rng.standard_normal(shape) for _ in op.forward_output_fields]
    ts = [_t(a, True) for a in ins]
    outs = _tuple(op.torch_function(periodic=periodic)(*ts))
    grads = torch.autograd.grad(outs, ts, [_t(c) for c in cots])
    jf = jop.jax_function(lowering="jnp", periodic=periodic)
    j_outs, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in ins))
    j_grads = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1
                  else jnp.asarray(cots[0]))
    for a, b in zip([o.detach() for o in outs] + list(grads),
                    list(_tuple(j_outs)) + list(j_grads)):
        _close(a.numpy(), b)


@pytest.mark.parametrize("memo", [memoize_model, jmemo.memoize_model],
                         ids=["port", "jax"])
def test_memoize_model(memo):
    """The port's copy behaves as the JAX package's: equal arguments give
    the same object, unhashable ones a fresh construction."""
    calls = []

    @memo
    def build(a, b=1):
        calls.append((a, b))
        return object()

    assert build(1, b=2) is build(1, b=2)
    assert build(1) is not build(2)
    assert build([1]) is not build([1])  # unhashable: never cached
    assert len(calls) == 5
    build.cache_clear()
    build(1, b=2)
    assert len(calls) == 6
    assert burgers2d_op(nu=0.1) is burgers2d_op(nu=0.1)
    assert laplacian3d_op() is laplacian3d_op()


# --------------------------------------------------------------- kernel pair --

def _tfmad_op():
    x, y, k = fields("x, y, k", 2, dtype="float64")
    return AutoDiffOp([Assignment(y.center, k[1, 0] * x[1, 0]
                                  + k[-1, 0] * x[-1, 0] * x[0, 0])],
                      op_name="tfmad", diff_mode="transposed-forward")


PAIR_OPS = {
    "heat_kappa": lambda: heat_step_op(kappa_field=True, dtype="float64"),
    "burgers2d": lambda: burgers2d_op(),
    "laplacian3d": lambda: laplacian3d_op(dtype="float64"),
    "tfmad": _tfmad_op,
}


def _backward_inputs(op):
    """The fields the full-domain backward reads (every stage's inputs that
    no earlier stage writes)."""
    written, names = set(), []
    for p in backward_programs(op):
        names += [f.name for f in p.input_fields
                  if f.name not in written and f.name not in names]
        written |= set(p.output_names)
    return names


def _pair_case(op, seed=9):
    shape = SHAPE3 if op.forward_input_fields[0].spatial_dimensions == 3 \
        else SHAPE2
    rng = np.random.default_rng(seed)
    fwd = {f.name: rng.standard_normal(shape)
           for f in op.forward_input_fields}
    bwd = {n: rng.standard_normal(shape) for n in _backward_inputs(op)}
    return fwd, bwd


def _pair_vs_jax(op, periodic):
    pair = op.kernel_pair(periodic=periodic)
    assert isinstance(pair, AutoDiffKernelPair)
    jpair = jax_twin(op).kernel_pair(lowering="jnp", periodic=periodic)
    fwd, bwd = _pair_case(op)
    got = _tuple(pair(**{n: torch.tensor(a) for n, a in fwd.items()}))
    ref = _tuple(jpair(**{n: jnp.asarray(a) for n, a in fwd.items()}))
    for a, b in zip(got, ref):
        _close(a.numpy(), b)
    got = _tuple(pair.backward(**{n: torch.tensor(a)
                                  for n, a in bwd.items()}))
    ref = _tuple(jpair.backward(**{n: jnp.asarray(a) for n, a in bwd.items()}))
    assert len(got) == len(ref) == len(op.backward_output_fields)
    for a, b in zip(got, ref):
        _close(a.numpy(), b)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name", sorted(PAIR_OPS))
def test_kernel_pair_matches_jax(name, periodic):
    """Forward in interior mode, backward the full-domain VJP (a staged
    TF_MAD backward runs its stages in order), as the JAX package's pair;
    or both periodic."""
    _pair_vs_jax(PAIR_OPS[name](), periodic)


def test_kernel_accessors():
    op = heat_step_op(kappa_field=True, dtype="float64")
    fwd, bwd = _pair_case(op)
    pair = op.kernel_pair()
    out = op.forward_kernel_gpu({n: _t(a) for n, a in fwd.items()})
    _close(out["u_next"].numpy(),
           pair.forward(**{n: _t(a) for n, a in fwd.items()}).numpy())
    grads = op.backward_kernel_gpu({n: _t(a) for n, a in bwd.items()})
    ref = pair.backward(**{n: _t(a) for n, a in bwd.items()})
    for f, r in zip(op.backward_output_fields, ref):
        _close(grads[f.name].numpy(), r.numpy())
    jop = jax_twin(op)
    j_out = jop.forward_kernel_tpu({n: jnp.asarray(a) for n, a in fwd.items()})
    _close(out["u_next"].numpy(), j_out["u_next"])


# ------------------------------------------------------------------ bridges --

def test_create_pytorch_op_is_torch_function():
    op = heat_step_op(kappa_field=True, dtype="float64")
    fwd, _ = _pair_case(op)
    f = op.create_pytorch_op(backend="torch")
    ts = {n: _t(a, True) for n, a in fwd.items()}
    out = f(**ts)
    (g,) = torch.autograd.grad(out.square().sum(), [ts["kappa"]])
    ref = op.torch_function()(**{n: _t(a, True) for n, a in fwd.items()})
    _close(out.detach().numpy(), ref.detach().numpy())
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    per = op.create_pytorch_op(periodic=True)(**ts)
    _close(per.detach().numpy(), op.torch_function(periodic=True)(
        **ts).detach().numpy())
    with pytest.raises(ValueError, match="unknown torch backend"):
        op.create_pytorch_op(backend="cuda")


def _bridge_oracle(op, fwd, cot):
    """The JAX package's value and gradients (``jax_function(lowering=
    "jnp")`` and ``jax.vjp``), by input name."""
    f = jax_twin(op).jax_function(lowering="jnp")
    names = [g.name for g in op.forward_input_fields]
    out, vjp = jax.vjp(f, *(jnp.asarray(fwd[n]) for n in names))
    return np.asarray(out), dict(zip(names, (np.asarray(g) for g in
                                             vjp(jnp.asarray(cot)))))


def _bridge_torch_native(op, fwd, cot):
    f = op.create_pytorch_op(backend="torch_native")
    ts = {n: _t(a, True) for n, a in fwd.items()}
    out = f(**ts)
    grads = torch.autograd.grad(out, list(ts.values()), _t(cot))
    return out.detach().numpy(), {n: g.numpy()
                                  for n, g in zip(ts, grads)}


def _bridge_tensorflow(op, fwd, cot):
    tf = pytest.importorskip("tensorflow")
    f = op.create_tensorflow_op()
    vs = [tf.Variable(fwd[n]) for n in f.input_names]
    with tf.GradientTape() as tape:
        out = f(*vs)
    grads = tape.gradient(out, vs, output_gradients=tf.constant(cot))
    return out.numpy(), {n: g.numpy() for n, g in zip(f.input_names, grads)}


def _bridge_native(op, fwd, cot):
    pair = op.create_native_op()
    out = pair.forward(**fwd)["u_next"]
    return out, pair.backward({"u_next": cot}, saved=fwd)


def _bridge_forward_cpu(op, fwd, cot):
    return op.forward_kernel_cpu(fwd)["u_next"], None


def _bridge_kernels_cpu(op, fwd, cot):
    """The two compiled kernels by hand: the cotangent masked to the
    forward interior, then the full-domain backward."""
    out = op.forward_kernel_cpu(fwd)["u_next"]
    masked = np.zeros_like(cot)
    sl = forward_program(op).interior_slices()
    masked[sl] = cot[sl]
    bwd = op.backward_kernel_cpu
    grads = bwd({**fwd, bwd.program.input_fields[0].name: masked})
    return out, {f.corresponding_forward_field.name: grads[f.name]
                 for f in op.backward_output_fields}


@pytest.mark.parametrize("call", [
    _bridge_torch_native, _bridge_tensorflow, _bridge_native,
    _bridge_forward_cpu, _bridge_kernels_cpu,
], ids=["torch_native", "tensorflow", "native", "forward_cpu",
        "backward_cpu"])
def test_bridges_run_on_the_cpu(call):
    """Each of the JAX package's bridges runs on the CPU with the port's
    op: the κ-heat step's value and gradients equal the JAX package's."""
    op = heat_step_op(kappa_field=True, dtype="float64")
    fwd, _ = _pair_case(op)
    cot = _rand(10, SHAPE2)
    out, grads = call(op, fwd, cot)
    ref_out, ref_grads = _bridge_oracle(op, fwd, cot)
    _close(out, ref_out)
    if grads is not None:
        assert set(grads) == set(ref_grads)
        for n in ref_grads:
            _close(grads[n], ref_grads[n])
