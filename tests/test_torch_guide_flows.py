"""The user guide's time-loop and domain-decomposition pages run: every
python block of ``timeloop.md`` and ``sharding.md`` on CPU tensors, one
case a block (see ``test_torch_guide.py``)."""

import pytest

from test_torch_guide import guide_cases, run_block

PAGES = ("timeloop", "sharding")


@pytest.mark.parametrize("page, index", guide_cases(PAGES),
                         ids=lambda v: str(v))
def test_guide_block_runs_on_cpu_tensors(page, index):
    run_block(page, index)
