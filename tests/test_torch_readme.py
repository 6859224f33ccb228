"""The port's quickstart in README.md must run: its first python block
under "PyTorch / CUDA port", on CPU tensors (the block picks the card;
the test swaps its device line for the CPU)."""

import pathlib
import re

import torch

README = pathlib.Path(__file__).resolve().parent.parent / "README.md"
CARD_LINE = 'device = "cuda"'


def test_port_readme_quickstart_runs_on_cpu_tensors():
    text = README.read_text()
    section = text.split("## PyTorch / CUDA port", 1)[1]
    blocks = re.findall(r"```python\n(.*?)```", section, re.S)
    assert blocks, "the port's README section lost its quickstart block"
    code = blocks[0]
    assert CARD_LINE in code, "the quickstart no longer names its device"
    assert "import jax" not in code and "pystencils_autodiff_tpu " not in code
    ns = {}
    exec(compile(code.replace(CARD_LINE, 'device = "cpu"'), "README.md",
                 "exec"), ns)
    assert ns["y"].shape == (64, 64) and ns["y"].device.type == "cpu"
    assert torch.isfinite(ns["k0"].grad).all()
    assert ns["k0"].grad.abs().max() > 0
