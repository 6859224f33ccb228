"""The port's user guide runs: every python block of the pages below, in
order in one namespace a page, on CPU tensors (each ``device = "cuda"``
line swapped for the CPU, as ``test_torch_readme.py`` does for the
README), one case a block.  No block imports JAX or the JAX package.
The other pages' blocks run in ``test_torch_guide_flows.py`` and
``test_torch_guide_bridges.py``; the card runs them all in
``test_torch_guide_card.py``."""

import pytest

from chip_smoke import GUIDE_CARD_LINE, GuidePage, guide_blocks

PAGES = ("getting_started", "architecture", "adjoint", "lowering",
         "performance", "migration", "testing")
_RUN = {}


def guide_cases(pages):
    """(page, block index) of every python block of ``pages``."""
    return [(page, i) for page in pages for i in range(len(guide_blocks(page)))]


def run_block(page, i, device="cpu"):
    """Block ``i`` of ``page`` on ``device``, after the page's earlier
    blocks (each page one namespace, shared by its cases)."""
    guide = _RUN.setdefault((page, device), GuidePage(page, device))
    if i == 0:
        assert GUIDE_CARD_LINE in guide.blocks[0], \
            f"{page}.md's first block no longer names its device"
    return guide.run_to(i)


@pytest.mark.parametrize("page, index", guide_cases(PAGES),
                         ids=lambda v: str(v))
def test_guide_block_runs_on_cpu_tensors(page, index):
    run_block(page, index)


def test_getting_started_results_on_cpu():
    """The quickstart's values: the op's output and gradients where the
    page computes them, on the CPU."""
    import torch

    ns = run_block("getting_started", len(guide_blocks("getting_started")) - 1)
    assert ns["y"].shape == (64, 64) and ns["y"].device.type == "cpu"
    assert torch.isfinite(ns["k0"].grad).all() and ns["k0"].grad.abs().max() > 0
    assert ns["v0"].grad.shape == (32, 32, 2)
