"""The user guide's backends page runs: every python block of
``backends.md`` on CPU tensors, one case a block (the generated C
kernels, ``torch_native``, TensorFlow where installed, and an exported
artifact saved and loaded; see ``test_torch_guide.py``)."""

import pytest

from test_torch_guide import guide_cases, run_block

PAGES = ("backends",)


@pytest.mark.parametrize("page, index", guide_cases(PAGES),
                         ids=lambda v: str(v))
def test_guide_block_runs_on_cpu_tensors(page, index):
    run_block(page, index)
