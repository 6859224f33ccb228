"""The command line the port's examples share: ``--device`` (the card,
``cuda``, unless ``--device cpu`` is given) and the repository root on
``sys.path`` so that ``python examples/torch_port/<name>.py`` runs from a
checkout.  Without a CUDA device and without ``--device cpu`` an example
stops before it does any work."""

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; "
                         "--device cpu runs the plain PyTorch versions)")
    return ap


def device(name: str):
    """``torch.device(name)``; exits naming ``--device cpu`` where ``name``
    is a CUDA device and none is available."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"{Path(sys.argv[0]).name}: no CUDA device is available; "
                 f"these examples run on the card by default — pass "
                 f"--device cpu to run them on the CPU")
    return dev


def parse(ap: argparse.ArgumentParser, argv=None):
    """(arguments, device) of a command line."""
    args = ap.parse_args(argv)
    return args, device(args.device)


def seeded(seed: int):
    """A CPU ``torch.Generator`` seeded with ``seed``: inputs are drawn on
    the CPU and moved, so the card and the CPU run see the same ones."""
    import torch

    return torch.Generator().manual_seed(seed)
