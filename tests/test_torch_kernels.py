"""Each single-step Pallas kernel on the main path against the port's plain
version of the CUDA kernel that replaces it, in float64 on the CPU.

The Pallas side runs in interpret mode with its strategy named explicitly
at the kernel level (``make_pallas_stencil(..., strategy=...)``), so each
kernel is called with the semantics it was built for.  The CUDA kernel
itself runs only on a card: the ``cuda``-marked test compares it with the
plain version there and skips elsewhere; the emitted source is checked
here without nvcc.  The JAX side is imported inside the tests that use
it, so ``pytest -m cuda`` also runs where jax is not installed."""

import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field
from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
    generate_cuda_source
from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                  heat_step3d_op, heat_step_op)
from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                               forward_program,
                                               make_cuda_stencil, make_stencil,
                                               make_torch_stencil)
from pystencils_autodiff_tpu_torch.ops.common import storage_shape
from torch_jax_twin import jax_twin

RTOL = 1e-12
SHAPE2, SHAPE3 = (24, 20), (8, 10, 12)


def _vector_op(layout):
    v = Field("v", 2, index_shape=(2,), layout=layout)
    w = Field("w", 2, index_shape=(2,), layout=layout)
    c = Field("c", 2)
    return AutoDiffOp([
        Assignment(w.center(0), v[1, 0](0) * c[0, 0] - v[0, -1](1)),
        Assignment(w.center(1), v[0, 1](0) * v[-1, 0](1) + c[0, 1]),
    ], op_name=f"vec_{layout}")


def _heat():
    return heat_step_op(kappa_field=True, dtype="float64")


def _arrays(prog, spatial, seed):
    rng = np.random.default_rng(seed)
    return {f.name: rng.standard_normal(storage_shape(f, spatial))
            for f in prog.input_fields}


def _check(port_fn, ref, arrays):
    got = port_fn({n: torch.tensor(a) for n, a in arrays.items()})
    assert set(got) == set(ref)
    for n, r in ref.items():
        r = np.asarray(r)
        np.testing.assert_allclose(got[n].numpy(), r, rtol=RTOL,
                                   atol=RTOL * np.abs(r).max(), err_msg=n)


def _jax():
    """(jax.numpy, the JAX package's ops.common, its pallas_kernel)."""
    import jax.numpy as jnp

    from pystencils_autodiff_tpu.ops import common, pallas_kernel
    return jnp, common, pallas_kernel


def _programs(op, kind):
    """The port's program of ``op`` and the JAX package's of its twin."""
    _, jcommon, _ = _jax()
    if kind == "fwd":
        return forward_program(op), jcommon.forward_program(jax_twin(op))
    return backward_program(op), jcommon.backward_program(jax_twin(op))


# (case id, op factory, program, port kwargs, pallas kwargs)
_GHOST2 = ((1, 1), (1, 1))
CASES = [
    # _run_whole_array: every field one block, any mode; index fields
    ("whole-fwd", _heat, "fwd", {}, {"strategy": "whole"}),
    ("whole-bwd-mask", _heat, "bwd",
     {"full_domain": True, "adjoint_mask_ghost": _GHOST2},
     {"strategy": "whole", "full_domain": True,
      "adjoint_mask_ghost": _GHOST2}),
    ("whole-vec-aos-bwd", lambda: _vector_op("aos"), "bwd",
     {"full_domain": True, "adjoint_mask_ghost": _GHOST2},
     {"strategy": "whole", "full_domain": True,
      "adjoint_mask_ghost": _GHOST2}),
    ("whole-vec-soa-fwd", lambda: _vector_op("soa"), "fwd", {},
     {"strategy": "whole"}),
    # _run_blocked with 8-row tiles: forward, masked backward, periodic
    ("blocked-fwd", _heat, "fwd", {}, {"strategy": "blocked", "tile_rows": 8}),
    ("blocked-bwd-mask", _heat, "bwd",
     {"full_domain": True, "adjoint_mask_ghost": _GHOST2},
     {"strategy": "blocked", "tile_rows": 8, "full_domain": True,
      "adjoint_mask_ghost": _GHOST2}),
    ("blocked-fwd-periodic", _heat, "fwd", {"periodic": True},
     {"strategy": "blocked", "tile_rows": 8, "periodic": True}),
    ("blocked-bwd-periodic", _heat, "bwd",
     {"full_domain": True, "periodic": True},
     {"strategy": "blocked", "tile_rows": 8, "full_domain": True,
      "periodic": True}),
    ("blocked-vec-soa-bwd", lambda: _vector_op("soa"), "bwd",
     {"full_domain": True, "adjoint_mask_ghost": _GHOST2},
     {"strategy": "blocked", "tile_rows": 8, "full_domain": True,
      "adjoint_mask_ghost": _GHOST2}),
    # _run_plane_single: the 3D heat forward in 4-plane tiles
    ("plane-heat3d-fwd", lambda: heat_step3d_op(dtype="float64"), "fwd", {},
     {"strategy": "plane", "tile_rows": 4}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_version_matches_pallas_kernel(case):
    jnp, _, pk = _jax()
    _, make_op, kind, port_kw, pallas_kw = case
    op = make_op()
    prog, jprog = _programs(op, kind)
    spatial = SHAPE3 if prog.ndim == 3 else SHAPE2
    arrays = _arrays(prog, spatial, seed=len(case[0]))
    ref = pk.make_pallas_stencil(jprog, interpret=True, **pallas_kw)(
        {n: jnp.asarray(a) for n, a in arrays.items()})
    _check(make_torch_stencil(prog, **port_kw), ref, arrays)


def test_plain_version_matches_plane_full_masked_backward():
    """_run_plane_full: the 3D exact-VJP backward with the fused mask."""
    jnp, _, pk = _jax()
    op = diffusion3d_op(dtype="float64")
    prog, jprog = _programs(op, "bwd")
    ghost = forward_program(op).ghost
    arrays = _arrays(prog, SHAPE3, seed=3)
    ref = pk.make_pallas_stencil(jprog, full_domain=True, interpret=True,
                                 strategy="plane_full", tile_rows=4,
                                 adjoint_mask_ghost=ghost)(
        {n: jnp.asarray(a) for n, a in arrays.items()})
    _check(make_torch_stencil(prog, full_domain=True,
                              adjoint_mask_ghost=ghost), ref, arrays)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_plain_version_matches_plane_kernels_periodic(kind):
    """The periodic 3D modes of _run_plane_single (forward) and
    _run_plane_full (backward), called directly: make_pallas_stencil
    reaches them only above 2 MB per array."""
    jnp, _, pk = _jax()
    op = heat_step3d_op(dtype="float64")
    prog, jprog = _programs(op, kind)
    arrays = _arrays(prog, SHAPE3, seed=4)
    jin = {n: jnp.asarray(a) for n, a in arrays.items()}
    if kind == "fwd":
        ref = pk._run_plane_single(jprog, jin, SHAPE3, jnp.float64, True,
                                   tile_rows=4, periodic=True)
        port = make_torch_stencil(prog, periodic=True)
    else:
        ref = pk._run_plane_full(jprog, jin, SHAPE3, jnp.float64, True,
                                 tile_rows=4, periodic=True)
        port = make_torch_stencil(prog, full_domain=True, periodic=True)
    _check(port, ref, arrays)


def test_emitted_cuda_source_reads():
    """The emitted body for the heat backward: adjoint reads (zero-extended,
    masked) of the cotangent, primal reads of u and κ, two output planes."""
    src = generate_cuda_source(backward_program(_heat()))
    assert '#include "stencil_step.cuh"' in src
    assert "#define PSAT_ND 2" in src
    assert "#define PSAT_NIN 3" in src and "#define PSAT_NOUT 2" in src
    for o in ("0, 0", "-1, 0", "1, 0", "0, -1", "0, 1"):
        assert f"c.ra(0, {o}, 0)" in src  # cotangent: adjoint read
        assert f"c.rp(1, {o}, 0)" in src or f"c.rp(2, {o}, 0)" in src
    assert "v[0] = " in src and "v[1] = " in src
    assert "T(0.1)" in src and "double" not in src


def test_emitted_cuda_source_accumulation_and_functions():
    x, y, k = Field("x", 2), Field("y", 2), Field("k", 2)
    import sympy as sp
    op = AutoDiffOp([Assignment(y.center, sp.sin(k[1, 0]) * x[1, 0] ** 3
                                + sp.sqrt(k[0, 0]) * x[0, 0])],
                    op_name="accum_fn", time_constant_fields=[k])
    src = generate_cuda_source(backward_program(op))
    assert "+= c.ra(" in src  # prev + val for the += adjoint of k
    assert "sin(" in src and "sqrt(" in src
    assert "pow(" not in src  # integer powers are multiplied out


def _vector3d_op():
    v, w = Field("v", 3, index_shape=(2,)), Field("w", 3)
    return AutoDiffOp([Assignment(w.center, v[1, 0, 0](0) - v[0, 0, -1](1))],
                      op_name="vec3d")


# (case id, op factory, program, full_domain, periodic, spatial, dtype,
#  the Pallas kernel make_pallas_stencil's auto-select runs)
_F32, _F64 = np.float32, np.float64
COUNTERPART_CASES = [
    ("heat-fwd-64", _heat, "fwd", False, False, (64, 64), _F32,
     "_run_whole_array"),
    ("heat-fwd-8192", _heat, "fwd", False, False, (8192,) * 2, _F32,
     "_run_blocked"),
    ("heat-bwd-8192", _heat, "bwd", True, False, (8192,) * 2, _F32,
     "_run_blocked"),
    ("heat-bwd-16-f64", _heat, "bwd", True, False, (16, 16), _F64,
     "_run_whole_array"),
    ("heat-fwd-periodic-8192", _heat, "fwd", False, True, (8192,) * 2, _F32,
     "_run_blocked"),
    ("heat-fwd-periodic-64", _heat, "fwd", False, True, (64, 64), _F32,
     "_run_blocked"),
    ("heat-bwd-periodic-64", _heat, "bwd", True, True, (64, 64), _F32,
     "_run_blocked"),
    ("heat-fwd-periodic-20rows", _heat, "fwd", False, True, (20, 20), _F32,
     "jnp"),
    ("vec-aos-bwd-2048", lambda: _vector_op("aos"), "bwd", True, False,
     (2048,) * 2, _F32, "_run_blocked"),
    ("diffusion3d-fwd-384", diffusion3d_op, "fwd", False, False, (384,) * 3,
     _F32, "_run_blocked"),
    ("diffusion3d-bwd-384", diffusion3d_op, "bwd", True, False, (384,) * 3,
     _F32, "_run_plane_full"),
    ("heat3d-fwd-384", heat_step3d_op, "fwd", False, False, (384,) * 3, _F32,
     "_run_plane_single"),
    ("heat3d-fwd-64", heat_step3d_op, "fwd", False, False, (64,) * 3, _F32,
     "_run_whole_array"),
    ("heat3d-fwd-periodic-384", heat_step3d_op, "fwd", False, True,
     (384,) * 3, _F32, "_run_plane_single"),
    ("heat3d-bwd-periodic-384", heat_step3d_op, "bwd", True, True, (384,) * 3,
     _F32, "_run_plane_full"),
    ("heat3d-bwd-periodic-64", heat_step3d_op, "bwd", True, True, (64,) * 3,
     _F32, "jnp"),
    ("heat3d-fwd-periodic-small", heat_step3d_op, "fwd", False, True, SHAPE3,
     _F32, "jnp"),
    ("vec3d-fwd-periodic-96", _vector3d_op, "fwd", False, True, (96,) * 3,
     _F32, "jnp"),
]


@pytest.mark.parametrize("case", COUNTERPART_CASES,
                         ids=[c[0] for c in COUNTERPART_CASES])
def test_pallas_counterpart_matches_pallas_auto_select(case, monkeypatch):
    """``chip_smoke.pallas_counterpart`` names the kernel that
    ``make_pallas_stencil`` really picks: its ``_run_*`` kernels and the jnp
    fallback are replaced by recorders, and the inputs are zero-stride
    arrays, so no kernel runs and no full-size array is allocated."""
    import chip_smoke
    from pystencils_autodiff_tpu.ops import jnp_ref
    from pystencils_autodiff_tpu.ops.common import storage_shape as jshape

    _, make_op, kind, full, periodic, spatial, dtype, expected = case
    _, _, pk = _jax()
    picked = []

    def recorder(name):
        def run(*args, **kwargs):
            picked.append(name)
            return {}
        return run

    for name in ("_run_whole_array", "_run_blocked", "_run_plane_single",
                 "_run_plane_full", "_run_row_tiled"):
        monkeypatch.setattr(pk, name, recorder(name))
    monkeypatch.setattr(jnp_ref, "make_jnp_stencil",
                        lambda *a, **k: recorder("jnp"))
    op = make_op()
    prog, jprog = _programs(op, kind)
    mask = forward_program(op).ghost if full and not periodic else None
    inputs = {f.name: np.broadcast_to(np.zeros((), dtype), jshape(f, spatial))
              for f in jprog.input_fields}
    pk.make_pallas_stencil(jprog, full_domain=full, periodic=periodic,
                           adjoint_mask_ghost=mask, interpret=False)(inputs)
    assert picked == [expected]
    assert chip_smoke.pallas_counterpart(
        prog, full, periodic, spatial, np.dtype(dtype).itemsize) == expected


def test_device_dispatch_on_cpu_tensors():
    """The op's lowering runs the plain version on CPU tensors; the kernel
    wrapper refuses them."""
    prog = forward_program(_heat())
    arrays = {n: torch.tensor(a) for n, a in _arrays(prog, SHAPE2, 5).items()}
    got = make_stencil(prog)(arrays)
    plain = make_torch_stencil(prog)(arrays)
    assert torch.equal(got["u_next"], plain["u_next"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        make_cuda_stencil(prog)(arrays)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is compiled with nvcc "
                    "for sm_90a and has no CPU mode)")
    return torch.device("cuda", 0)


KERNEL_CASES = [
    ("heat-fwd", _heat, "fwd", {}),
    ("heat-bwd-mask", _heat, "bwd",
     {"full_domain": True, "adjoint_mask_ghost": _GHOST2}),
    ("heat-fwd-periodic", _heat, "fwd", {"periodic": True}),
    ("heat-bwd-periodic", _heat, "bwd", {"full_domain": True, "periodic": True}),
    ("vec-aos-bwd", lambda: _vector_op("aos"), "bwd",
     {"full_domain": True, "adjoint_mask_ghost": _GHOST2}),
    ("vec-soa-fwd", lambda: _vector_op("soa"), "fwd", {}),
    ("diffusion3d-bwd-mask", lambda: diffusion3d_op(dtype="float64"), "bwd",
     {"full_domain": True, "adjoint_mask_ghost": ((1, 1),) * 3}),
    ("heat3d-fwd-periodic", lambda: heat_step3d_op(dtype="float64"), "fwd",
     {"periodic": True}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def test_cuda_kernel_matches_plain_version(case, dtype, cuda_device):
    """On the card: kernel vs plain version on the same CUDA tensors (FMA
    contraction and summation order differ: rtol 1e-12 in f64, 1e-5 in
    f32, atol the same fraction of max |ref|)."""
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck

    _, make_op, kind, kw = case
    op = make_op()
    prog = forward_program(op) if kind == "fwd" else backward_program(op)
    spatial = SHAPE3 if prog.ndim == 3 else SHAPE2
    inputs = {n: torch.tensor(a, dtype=dtype, device=cuda_device)
              for n, a in _arrays(prog, spatial, 6).items()}
    before = ck.LAUNCHES
    got = make_cuda_stencil(prog, **kw)(inputs)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before + 1
    ref = make_torch_stencil(prog, **kw)(inputs)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for n, r in ref.items():
        torch.testing.assert_close(got[n], r, rtol=tol,
                                   atol=tol * r.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_cuda_kernel_leading_extent_above_grid_limit(kind, cuda_device):
    """A 70000×64 float32 grid: its leading extent is above the 65535
    blocks a grid's y dimension holds, which the launch once mapped it to.
    Forward interior and full+mask backward vs the plain version (rtol
    1e-5, atol 1e-5·max|ref|)."""
    op = heat_step_op(kappa_field=True)
    prog = forward_program(op) if kind == "fwd" else backward_program(op)
    kw = {} if kind == "fwd" else {"full_domain": True,
                                   "adjoint_mask_ghost": _GHOST2}
    inputs = {n: torch.tensor(a, dtype=torch.float32, device=cuda_device)
              for n, a in _arrays(prog, (70000, 64), 10).items()}
    got = make_cuda_stencil(prog, **kw)(inputs)
    torch.cuda.synchronize()
    ref = make_torch_stencil(prog, **kw)(inputs)
    for n, r in ref.items():
        torch.testing.assert_close(got[n], r, rtol=1e-5,
                                   atol=1e-5 * r.abs().max().item())


@pytest.mark.cuda
def test_launch_on_another_card_keeps_the_current_device(cuda_device):
    """A launch on cuda:1 runs there and leaves the thread's current device
    as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    prog = forward_program(_heat())
    dev1 = torch.device("cuda", 1)
    inputs = {n: torch.tensor(a, device=dev1)
              for n, a in _arrays(prog, SHAPE2, 9).items()}
    current = torch.cuda.current_device()
    got = make_cuda_stencil(prog)(inputs)
    torch.cuda.synchronize(dev1)
    assert torch.cuda.current_device() == current
    ref = make_torch_stencil(prog)(inputs)
    torch.testing.assert_close(got["u_next"], ref["u_next"], rtol=1e-12,
                               atol=1e-12 * ref["u_next"].abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def test_cuda_kernel_in_bf16(case, cuda_device):
    """bf16 tensors on the card: stored bf16, computed in float; the
    output within 0.05 of max |ref| of the plain version in f32 on the same
    bf16-rounded inputs."""
    _, make_op, kind, kw = case
    op = make_op()
    prog = forward_program(op) if kind == "fwd" else backward_program(op)
    spatial = SHAPE3 if prog.ndim == 3 else SHAPE2
    inputs = {n: torch.tensor(a, dtype=torch.bfloat16, device=cuda_device)
              for n, a in _arrays(prog, spatial, 7).items()}
    got = make_cuda_stencil(prog, **kw)(inputs)
    torch.cuda.synchronize()
    ref = make_torch_stencil(prog, **kw)({n: t.float()
                                          for n, t in inputs.items()})
    for n, r in ref.items():
        assert got[n].dtype == torch.bfloat16
        assert (got[n].float() - r).abs().max() <= 0.05 * r.abs().max()
