"""The port's example scripts on the card: each script's ``main`` on
``cuda:0`` at its published size with its own asserts, each through the
port's kernels (launch counters), and the Cahn–Hilliard spinodal's fused
stage chain (kernel 12, periodic) against its replay at 1024² float32.
Every test here needs a CUDA device and skips without one."""

import pytest
import torch

from chip_smoke import EXAMPLE_NAMES as NAMES
from chip_smoke import example_module as example

from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
from pystencils_autodiff_tpu_torch.ops import torch_ref


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are compiled with nvcc "
                    "for sm_90a and have no CPU mode)")


# the kernels each flow reaches on CUDA tensors, by launch counter
REACHES = {name: (ck,) for name in NAMES}
REACHES["lbm_cavity"] = (ck, sc, sa)
REACHES["phasefield_spinodal"] = (ck, sc)
REACHES["sharded_diffusion"] = (ck, sc, sa)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_card(name):
    _need_card()
    for mod in (ck, sc, sa):
        mod.reset_launch_counts()
    plain = torch_ref.PLAIN_CALLS
    example(name).main(["--device", "cuda:0"])
    for mod in REACHES[name]:
        assert mod.LAUNCHES > 0, (name, mod.__name__)
    # the flows run on the kernels, never on the plain versions
    assert torch_ref.PLAIN_CALLS == plain, name


@pytest.mark.cuda
def test_spinodal_fused_against_replay_f32():
    """1024² float32, k=2, 8 cycles: 4 launches of kernel 12 against 16
    window launches, to the f32 contract (rtol 1e-5, atol 1e-5·max|ref|)."""
    _need_card()
    ex = example("phasefield_spinodal")
    dh = ex.record(ex.initial_phi(1024, torch.float32, "cuda"))
    run_replay, run_fused = ex.compiled(dh)
    st = dh.state()
    with torch.no_grad():
        sc.reset_launch_counts()
        out_f = run_fused(st, 8)
        assert sc.LAUNCHES == 4
        ck.reset_launch_counts()
        out_r = run_replay(st, 8)
        assert ck.LAUNCHES == 16
    ref = out_r["phi"]
    tol = 1e-5 * ref.abs().max().item()
    assert ((out_f["phi"] - ref).abs() <= tol + 1e-5 * ref.abs()).all()
