"""The user guide on the card: every python block of every page of
``docs/torch_port/`` on CUDA tensors, in order in one namespace a page,
one case a block (the blocks as written: their ``device = "cuda"``
line stays); then each page that computes launched the port's kernels.
Every test here needs a CUDA device and skips without one."""

import pytest
import torch

from chip_smoke import GUIDE_PAGES, guide_blocks
from test_torch_guide import _RUN, guide_cases, run_block

# the pages whose blocks run no op on tensors of the device
NO_LAUNCH = ("index",)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are compiled with nvcc "
                    "for sm_90a and have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("page, index", guide_cases(GUIDE_PAGES),
                         ids=lambda v: str(v))
def test_guide_block_runs_on_the_card(page, index):
    _need_card()
    run_block(page, index, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("page", [p for p in GUIDE_PAGES
                                  if p not in NO_LAUNCH])
def test_guide_page_launches_the_kernels(page):
    _need_card()
    # the blocks the cases above left unrun (none where they all passed)
    run_block(page, len(guide_blocks(page)) - 1, "cuda")
    assert _RUN[(page, "cuda")].launches > 0, \
        f"{page}.md launched no kernel on the card"
