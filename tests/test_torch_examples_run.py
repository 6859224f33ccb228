"""The port's example scripts run as a user runs them: each as its own
``python`` process with ``--device cpu`` and with ``jax`` and the JAX
package blocked from import (the scripts import torch, numpy and the port
alone), to the end of their own asserts; and each refuses to start
without a card unless ``--device cpu`` is given.

The scripts run together, one process each, started by a fixture; the
ones that take longer than about 20 s here run at reduced counts through
their ``--steps`` argument."""

import os
import subprocess
import sys
import textwrap

import pytest

from chip_smoke import EXAMPLE_NAMES as NAMES
from chip_smoke import EXAMPLES_DIR as EXAMPLES

REPO = EXAMPLES.parents[1]
# reduced counts for the scripts that take longer at their published ones
STEPS = {"fwi_inversion": 3, "lbm_cavity": 20, "torch_tf_interop": 20}
BLOCKED_RUN = textwrap.dedent("""
    import runpy, sys
    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib",
                                      "pystencils_autodiff_tpu", "optax"):
                raise ImportError("blocked: " + name)
    sys.meta_path.insert(0, Block())
    script = sys.argv[1]
    sys.argv = sys.argv[1:]
    sys.path.insert(0, script.rsplit("/", 1)[0])
    runpy.run_path(script, run_name="__main__")
    bad = [m for m in sys.modules if m.split(".")[0] in
           ("jax", "jaxlib", "pystencils_autodiff_tpu", "optax")]
    assert not bad, bad
""")


def _env(**extra):
    env = dict(os.environ, **extra)
    env.pop("PYTHONPATH", None)  # the scripts find the port themselves
    return env


def _start(args, env):
    return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs():
    """Every script started at once with ``--device cpu``: name ->
    process."""
    procs = {}
    for name in NAMES:
        args = ["-c", BLOCKED_RUN, str(EXAMPLES / f"{name}.py"),
                "--device", "cpu"]
        if name in STEPS:
            args += ["--steps", str(STEPS[name])]
        procs[name] = _start(args, _env())
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


OK_LINES = {
    "heat_inverse_problem": ["OPTIMIZATION OK", "P5 mixed args: TypeError"],
    "fwi_inversion": ["FWI OK", "ELASTIC OK"],
    "lbm_cavity": ["cavity OK", "match the stepper"],
    "phasefield_spinodal": ["FUSED == REPLAY, physics OK",
                            "INVERSE PROBLEM OK"],
    "sharded_diffusion": ["fwd max err vs single-device: 0.0",
                          "fused-chain fused-backward grad: (64, 128)"],
    "elastic_simulation": ["SHARDED SIM OK", "P-empty: no sweeps added"],
    "torch_tf_interop": ["TORCH NATIVE OK", "f32 native ok: torch.float32"],
}


@pytest.mark.parametrize("name", NAMES)
def test_script_runs_on_the_cpu_with_jax_blocked(runs, name):
    out, err = runs[name].communicate(timeout=600)
    assert runs[name].returncode == 0, err[-4000:]
    for line in OK_LINES[name]:
        assert line in out, out
    if name == "torch_tf_interop":
        # the TensorFlow half runs where TensorFlow is installed, and says
        # so where it is not
        try:
            import tensorflow  # noqa: F401
        except ImportError:
            assert "the TensorFlow half did not run" in out
        else:
            assert "TF NATIVE OK" in out, out


def test_scripts_refuse_to_start_without_a_card():
    """No CUDA device visible and no ``--device cpu``: every script exits
    at once with an error naming the flag, having printed nothing."""
    env = _env(CUDA_VISIBLE_DEVICES="")
    procs = {name: _start([str(EXAMPLES / f"{name}.py")], env)
             for name in NAMES}
    for name, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode != 0, name
        assert "--device cpu" in err, (name, err[-2000:])
        assert out == "", (name, out)
