"""The slab single step (``strategy="tiled"``, the port of
``pallas_kernel.py::_run_row_tiled``) against the JAX package in float64 on
the CPU, its tile reckoning, and on a card the kernel against its plain
version.

On CPU tensors ``make_stencil(..., strategy="tiled")`` and
``torch_function(strategy="tiled")`` run the plain version, which is row
5's plain version too: the Pallas kernel runs in interpret mode on the
JAX side.  The kernel itself runs only on a card (``cuda`` marker)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pystencils_autodiff_tpu_torch import Field, fields
from pystencils_autodiff_tpu_torch.assignment import Assignment
from pystencils_autodiff_tpu_torch.autodiff import AutoDiffOp
from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                  heat_step_op, laplacian_op)
from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                               forward_program, make_stencil,
                                               make_torch_stencil)
from pystencils_autodiff_tpu_torch.ops import row_tiled as rt
from pystencils_autodiff_tpu_torch.ops.common import storage_shape
from pystencils_autodiff_tpu_torch.ops.time_chain import SM_SMEM, SMEM_BUDGET
from torch_jax_twin import jax_twin

RTOL = 1e-10


def _laplacian():
    x, y = fields("x, y", 2)
    return AutoDiffOp([Assignment(y.center, x[1, 0] + x[-1, 0] + x[0, 1]
                                  + x[0, -1] - 4 * x[0, 0])], op_name="lap")


def _d3():
    x, y, k = fields("x, y, k", 3)
    return AutoDiffOp([Assignment(
        y.center,
        k[0, 0, 0] * (x[1, 0, 0] + x[-1, 0, 0] + x[0, 1, 0] + x[0, -1, 0]
                      + x[0, 0, 1] + x[0, 0, -1] - 6 * x[0, 0, 0]))],
        op_name="d3")


def _arrays(prog, spatial, seed):
    rng = np.random.default_rng(seed)
    return {f.name: rng.standard_normal(storage_shape(f, spatial))
            for f in prog.input_fields}


def _pallas(op, kind, **kw):
    from pystencils_autodiff_tpu.ops import common as jcommon
    from pystencils_autodiff_tpu.ops import jnp_ref, pallas_kernel

    jop = jax_twin(op)
    jprog = (jcommon.forward_program(jop) if kind == "fwd"
             else jcommon.backward_program(jop))
    return (pallas_kernel.make_pallas_stencil(jprog, interpret=True, **kw),
            jnp_ref.make_jnp_stencil(
                jprog, **{k: v for k, v in kw.items()
                          if k in ("full_domain", "adjoint_mask_ghost")}))


def _assert_close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-300))


# (id, op, program, spatial, tile_rows, full_domain) — the shapes of
# tests/test_pallas.py's row-tiled tests: 5 tiles of 8 rows, a ragged last
# tile, the 3D variable-κ op in 4-row tiles
PROGRAM_CASES = [
    ("lap-40x24-interior", _laplacian, "fwd", (40, 24), 8, False),
    ("lap-40x24-full", _laplacian, "fwd", (40, 24), 8, True),
    ("lap-37x24-ragged", _laplacian, "fwd", (37, 24), 8, False),
    ("lap-37x24-ragged-full", _laplacian, "fwd", (37, 24), 8, True),
    ("d3-12x10x11", _d3, "fwd", (12, 10, 11), 4, False),
    ("heat-bwd-37x24-masked", lambda: heat_step_op(kappa_field=True,
                                                   dtype="float64"),
     "bwd", (37, 24), 8, True),
    ("diffusion3d-bwd-masked", lambda: diffusion3d_op(dtype="float64"),
     "bwd", (12, 10, 11), 4, True),
]


@pytest.mark.parametrize("case", PROGRAM_CASES,
                         ids=[c[0] for c in PROGRAM_CASES])
def test_tiled_stencil_matches_pallas_row_tiled_and_jnp(case):
    _, make_op, kind, spatial, tile_rows, full = case
    op = make_op()
    prog = forward_program(op) if kind == "fwd" else backward_program(op)
    kw = {"full_domain": full}
    if kind == "bwd":
        kw["adjoint_mask_ghost"] = forward_program(op).ghost
    pal, ref = _pallas(op, kind, strategy="tiled", tile_rows=tile_rows, **kw)
    arrays = _arrays(prog, spatial, seed=len(case[0]))
    port = make_stencil(prog, strategy="tiled", tile_rows=tile_rows, **kw)(
        {n: torch.tensor(a) for n, a in arrays.items()})
    jin = {n: jnp.asarray(a) for n, a in arrays.items()}
    want_pal, want_ref = pal(jin), ref(jin)
    for n in want_ref:
        _assert_close(port[n].numpy(), want_pal[n])
        _assert_close(port[n].numpy(), want_ref[n])


OPS = {
    "heat_kappa-2d": (lambda: heat_step_op(kappa_field=True, dtype="float64"),
                      (37, 24), 8),
    "laplacian-2d": (lambda: laplacian_op(dtype="float64"), (40, 24), 8),
    "diffusion3d": (lambda: diffusion3d_op(dtype="float64"), (12, 10, 11), 4),
}


def _value_and_vjp_jax(op, ins, cots, **kw):
    f = jax_twin(op).jax_function(**kw)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in ins))
    outs = out if isinstance(out, tuple) else (out,)
    grads = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1
                else jnp.asarray(cots[0]))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _value_and_vjp_torch(op, ins, cots, device="cpu", **kw):
    f = op.torch_function(**kw)
    ts = [torch.tensor(a, device=device, requires_grad=True) for a in ins]
    out = f(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(outs, ts, [torch.tensor(c, device=device)
                                           for c in cots])
    return ([o.detach().cpu().numpy() for o in outs],
            [g.cpu().numpy() for g in grads])


def _op_case(name, seed=0):
    make_op, spatial, tile_rows = OPS[name]
    op = make_op()
    rng = np.random.default_rng(seed)
    ins = [rng.standard_normal(storage_shape(f, spatial))
           for f in op.forward_input_fields]
    cots = [rng.standard_normal(storage_shape(f, spatial))
            for f in op.forward_output_fields]
    return op, ins, cots, tile_rows


@pytest.mark.parametrize("given_rows", [True, False])
@pytest.mark.parametrize("name", sorted(OPS))
def test_torch_function_tiled_matches_jax(name, given_rows):
    """Values and gradients of ``torch_function(strategy="tiled")`` against
    ``jax_function(lowering="jnp")`` and against the Pallas tiled path in
    interpret mode, f64, ghost cells included."""
    op, ins, cots, tile_rows = _op_case(name)
    rows = tile_rows if given_rows else None
    t_out, t_grad = _value_and_vjp_torch(op, ins, cots, strategy="tiled",
                                         tile_rows=rows)
    for kw in ({"lowering": "jnp"},
               {"lowering": "pallas", "strategy": "tiled",
                "tile_rows": tile_rows, "interpret": True}):
        j_out, j_grad = _value_and_vjp_jax(op, ins, cots, **kw)
        for got, want in zip(t_out + t_grad, j_out + j_grad):
            _assert_close(got, want)


def test_torch_function_tiled_periodic_runs_the_periodic_step():
    """``"tiled"`` with ``periodic=True`` computes the periodic step, as the
    JAX package's roll path does."""
    op, ins, cots, _ = _op_case("heat_kappa-2d", seed=3)
    t_out, t_grad = _value_and_vjp_torch(op, ins, cots, strategy="tiled",
                                         periodic=True)
    j_out, j_grad = _value_and_vjp_jax(op, ins, cots, lowering="jnp",
                                       periodic=True)
    for got, want in zip(t_out + t_grad, j_out + j_grad):
        _assert_close(got, want)


def test_tiled_rejects_index_fields_and_1d():
    v = Field("v", 2, index_shape=(2,))
    w = Field("w", 2)
    vec = AutoDiffOp([Assignment(w.center, v[1, 0](0) - v[0, 1](1))],
                     op_name="vec_tiled")
    with pytest.raises(ValueError, match="scalar"):
        vec.torch_function(strategy="tiled")
    with pytest.raises(ValueError, match="scalar"):
        make_stencil(forward_program(vec), strategy="tiled")
    x, y = Field("x", 1), Field("y", 1)
    one = AutoDiffOp([Assignment(y.center, x[1] - x[-1])], op_name="one_d")
    with pytest.raises(ValueError, match="2 spatial dims"):
        one.torch_function(strategy="tiled")
    with pytest.raises(ValueError, match="unknown strategy"):
        make_stencil(forward_program(_laplacian()), strategy="rows")


def test_slab_halo_is_the_read_reach():
    prog = backward_program(heat_step_op(kappa_field=True, dtype="float64"))
    assert rt.slab_halo(prog) == ((1, 1), (1, 1))
    x, y = fields("x, y", 3)
    lop = AutoDiffOp([Assignment(y.center, x[2, 0, -1] + x[0, -3, 1])],
                     op_name="skew")
    assert rt.slab_halo(forward_program(lop)) == ((0, 2), (3, 0), (1, 1))


@pytest.mark.parametrize("tile_rows", [None, 3, 16])
@pytest.mark.parametrize("spatial", [(8192, 8192), (37, 24), (384, 384, 384),
                                     (12, 10, 11)])
def test_slab_tile_honours_rows_and_fits_the_budget(spatial, tile_rows):
    """The streamed slab's geometry for 3 f32 planes at 16-byte copies:
    chunks of the power of two at or below ``tile_rows`` (default
    ``TILE_ROWS``) rows, halved where the ring would not fit (by default
    also until the resident blocks hold ``MIN_THREADS_PER_SM`` threads); the
    lateral tile ``LATERAL`` cut to the domain (x in whole warps); the x
    halo rounded out to whole 16-byte copies; a ring of 4 chunks; the
    blocks per SM that the SM's shared memory and threads hold."""
    nd = len(spatial)
    halo = ((1, 1),) * nd
    st = rt.slab_tile(halo, 3, 4, spatial, tile_rows)
    want = 1 << ((tile_rows or rt.TILE_ROWS[nd]).bit_length() - 1)
    assert st.tile[0] <= want and st.tile[0] & (st.tile[0] - 1) == 0
    assert st.tile[0] == want or rt.slab_tile(
        halo, 3, 4, spatial, st.tile[0] * 2).tile[0] == st.tile[0] or (
        tile_rows is None)
    if tile_rows is None:
        assert (st.blocks_per_sm * st.threads >= rt.MIN_THREADS_PER_SM
                or st.tile[0] == 1)
    lat = list(rt.LATERAL[nd])
    lat[-1] = min(lat[-1], -(-spatial[-1] // 32) * 32)
    if nd == 3:
        lat[0] = min(lat[0], spatial[1])
    assert st.tile[1:] == tuple(lat)
    assert st.halo[-1][0] == 4 and st.slab[-1] % 4 == 0
    assert st.slab[-1] >= st.tile[-1] + 5 and st.slab[0] == 4 * st.tile[0]
    if nd == 3:
        assert st.slab[1] == st.tile[1] + 2
    assert st.smem == 3 * 4 * int(np.prod(st.slab))
    assert st.smem <= SMEM_BUDGET and st.threads == int(np.prod(lat))
    assert 1 <= st.blocks_per_sm <= 2048 // st.threads
    assert st.blocks_per_sm * (st.smem + 1024) <= SM_SMEM


def test_slab_tile_shrinks_rows_then_raises_where_nothing_fits():
    # 10 f64 planes with a reach of 4: a ring of 8-row chunks does not
    # fit, 4-row chunks (the reach) do, and a given tile_rows is an upper
    # bound; 40 planes fit no ring
    st = rt.slab_tile(((4, 4), (4, 4)), 10, 8, (4096, 4096))
    assert st.tile[0] == 4 and st.smem <= SMEM_BUDGET
    assert rt.slab_tile(((4, 4), (4, 4)), 10, 8, (4096, 4096),
                        tile_rows=64).tile[0] == 4
    with pytest.raises(ValueError, match="40 input planes"):
        rt.slab_tile(((4, 4), (4, 4)), 40, 8, (4096, 4096))
    with pytest.raises(ValueError, match="no slab fits"):
        rt.slab_tile(((4, 4), (4, 4)), 40, 8, (4096, 4096), tile_rows=4)


def test_slab_route_follows_pointers_and_strides():
    """The copy width comes from the tensors alone, before any launch: 16
    bytes on contiguous rows of a multiple of 16 bytes, narrower where a
    row stride (the ragged 8190-wide f32 grid: 32,760 bytes) or the base
    address allows no more, per element where the last dim is strided or
    no width divides (bf16 rows of an odd length)."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert rt.slab_route([torch.zeros((8, 8192), dtype=f32)] * 2, 4) == 16
    assert rt.slab_route([torch.zeros((8, 8190), dtype=f32)], 4) == 8
    assert rt.slab_route([torch.zeros((8, 8191), dtype=f32)], 4) == 4
    assert rt.slab_route([torch.zeros((8, 64), dtype=torch.float64)],
                         8) == 16
    assert rt.slab_route([torch.zeros((8, 8191), dtype=bf16)], 2) == 0
    assert rt.slab_route([torch.zeros((8, 64), dtype=f32)[:, 1:]], 4) == 4
    assert rt.slab_route([torch.zeros((8, 64), dtype=f32).t()], 4) == 0
    # the launch arguments: rows, ring, and segments that fill 132 SMs
    st = rt.slab_tile(((1, 1), (1, 1)), 2, 4, (8192, 8192))
    _, slab = rt.slab_args(st, (8192, 8192), (1, 1), (8191, 8191), (0, 0),
                           (8192, 8192))
    assert list(slab)[6:8] == [st.tile[0], 4 * st.tile[0]]
    nseg = list(slab)[8]
    assert nseg * 64 <= st.blocks_per_sm * 132 < (nseg + 1) * 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is compiled with nvcc "
                    "for sm_90a and has no CPU mode)")
    return torch.device("cuda", 0)


# (id, op, program, spatial, kwargs of the step, tile_rows)
KERNEL_CASES = [
    ("heat-fwd-ragged", lambda: heat_step_op(kappa_field=True), "fwd",
     (37, 300), {}, None),
    ("heat-bwd-masked", lambda: heat_step_op(kappa_field=True), "bwd",
     (37, 300), {"full_domain": True, "adjoint_mask_ghost": ((1, 1),) * 2},
     3),
    ("lap-full", lambda: laplacian_op(), "fwd", (130, 70),
     {"full_domain": True}, 8),
    ("diffusion3d-fwd", lambda: diffusion3d_op(), "fwd", (12, 21, 45), {},
     None),
    ("diffusion3d-bwd-masked", lambda: diffusion3d_op(), "bwd", (12, 21, 45),
     {"full_domain": True, "adjoint_mask_ghost": ((1, 1),) * 3}, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_slab_kernel_matches_plain_version(case, dtype, cuda_device):
    """On the card: the slab kernel vs the plain version on the same
    tensors: rtol 1e-12 in f64, 1e-5 in f32 (atol the same fraction of
    max |ref|: FMA contraction and summation order differ); bf16 storage
    against the plain version in f32 on the same bf16-rounded inputs,
    0.05 of max |ref| (the output is rounded to bf16)."""
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck

    _, make_op, kind, spatial, kw, tile_rows = case
    op = make_op()
    prog = forward_program(op) if kind == "fwd" else backward_program(op)
    inputs = {n: torch.tensor(a, dtype=dtype, device=cuda_device)
              for n, a in _arrays(prog, spatial, 6).items()}
    before = dict(ck.LAUNCH_CALLS)
    got = make_stencil(prog, strategy="tiled", tile_rows=tile_rows,
                       **kw)(inputs)
    torch.cuda.synchronize()
    new = {k: n - before.get(k, 0) for k, n in ck.LAUNCH_CALLS.items()
           if n != before.get(k, 0)}
    assert list(new.values()) == [1] and list(new)[0][-1] == "slab"
    if dtype == torch.bfloat16:
        ref = make_torch_stencil(prog, **kw)(
            {n: t.float() for n, t in inputs.items()})
        for n, r in ref.items():
            err = (got[n].float() - r).abs().max().item()
            assert got[n].dtype == torch.bfloat16
            assert err <= 0.05 * r.abs().max().item(), (n, err)
        return
    ref = make_torch_stencil(prog, **kw)(inputs)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for n, r in ref.items():
        torch.testing.assert_close(got[n], r, rtol=tol,
                                   atol=tol * r.abs().max().item())


@pytest.mark.cuda
def test_torch_function_tiled_on_the_card_matches_jax(cuda_device):
    """The op through the slab kernel on CUDA tensors against the JAX
    package's jnp lowering, f64, values and gradients; every launch is a
    slab launch."""
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck

    for name in sorted(OPS):
        op, ins, cots, tile_rows = _op_case(name, seed=5)
        ck.reset_launch_counts()
        t_out, t_grad = _value_and_vjp_torch(op, ins, cots, "cuda",
                                             strategy="tiled",
                                             tile_rows=tile_rows)
        assert ck.LAUNCHES == 2
        assert all(key[-1] == "slab" for key in ck.LAUNCH_CALLS)
        j_out, j_grad = _value_and_vjp_jax(op, ins, cots, lowering="jnp")
        for got, want in zip(t_out + t_grad, j_out + j_grad):
            _assert_close(got, want)


# (id, op, program, spatial, kwargs of the step, columns of padding)
ROUTE_CASES = [
    ("heat-fwd-8191x8190", lambda: heat_step_op(kappa_field=True), "fwd",
     (8191, 8190), {}, 0),
    ("heat-bwd-8191x8190", lambda: heat_step_op(kappa_field=True), "bwd",
     (8191, 8190), {"full_domain": True, "adjoint_mask_ghost": ((1, 1),) * 2},
     0),
    ("heat-fwd-row-stride-pad3", lambda: heat_step_op(kappa_field=True),
     "fwd", (300, 256), {}, 3),
    ("diffusion3d-bwd-row-stride-pad1", lambda: diffusion3d_op(), "bwd",
     (20, 37, 64), {"full_domain": True, "adjoint_mask_ghost": ((1, 1),) * 3},
     1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_slab_kernel_copy_routes_on_the_card(case, dtype, cuda_device):
    """The slab kernel on the ragged 8191×8190 grid (f32 rows of 32,760
    bytes: 8-byte copies) and on inputs whose row stride is padded to no
    multiple of 16 bytes, 2D and 3D, against the plain version at the
    tolerances of ``test_slab_kernel_matches_plain_version``; the launch
    is counted under the copy width ``slab_route`` takes from the
    tensors."""
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck

    _, make_op, kind, spatial, kw, pad = case
    op = make_op()
    prog = forward_program(op) if kind == "fwd" else backward_program(op)
    inputs = {}
    for n, a in _arrays(prog, spatial, 7).items():
        t = torch.zeros(a.shape[:-1] + (a.shape[-1] + pad,), dtype=dtype,
                        device=cuda_device)
        t[..., :a.shape[-1]] = torch.tensor(a, dtype=dtype)
        inputs[n] = t[..., :a.shape[-1]]
    width = rt.slab_route(list(inputs.values()), dtype.itemsize)
    assert pad == 0 or width < 16
    before = dict(ck.LAUNCH_CALLS)
    got = make_stencil(prog, strategy="tiled", **kw)(inputs)
    torch.cuda.synchronize()
    new = [k for k, n in ck.LAUNCH_CALLS.items() if n != before.get(k, 0)]
    assert [k[5:] for k in new] == [(f"w{width}" if width else "elem",
                                     "slab")]
    if dtype == torch.bfloat16:
        ref = make_torch_stencil(prog, **kw)(
            {n: t.float() for n, t in inputs.items()})
        for n, r in ref.items():
            err = (got[n].float() - r).abs().max().item()
            assert err <= 0.05 * r.abs().max().item(), (n, err)
        return
    ref = make_torch_stencil(prog, **kw)(inputs)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for n, r in ref.items():
        torch.testing.assert_close(got[n], r, rtol=tol,
                                   atol=tol * r.abs().max().item())
