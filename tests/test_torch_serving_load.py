"""The torch-only load of the port's exported artifacts (``serving.py``'s
doc): each artifact kind the port exports, saved here, loads and runs in a
fresh ``python3`` that has neither the port, nor jax, nor the JAX package
(an import finder refuses them), nor a compiler on its ``PATH`` — only
PyTorch, ``json`` and the standard library, through
``chip_smoke.torch_only_load``.  Each case holds the loaded primal and VJP
bit for bit against the eager port and, in float64 to round-off (rtol
1e-10), against the JAX package's ``lowering="jnp"``.  SymPy is not
refused: ``torch.export.load`` imports it itself (torch 2.13,
``torch/_export/serde/serialize.py``).  Then the sidecar's checks: a
format-1 sidecar, a library outside the artifact's directory, a library
whose bytes changed and one that does not load each raise."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu import graph_datahandling as jgraph
from pystencils_autodiff_tpu.models.heat import heat_step_op as jheat
from torch_jax_twin import jax_twin

from pystencils_autodiff_tpu_torch.graph_datahandling import \
    GraphDataHandling
from pystencils_autodiff_tpu_torch.models import heat_step_op
from pystencils_autodiff_tpu_torch.ops import launch
from pystencils_autodiff_tpu_torch.serving import (export_op, export_program,
                                                   load_exported,
                                                   save_exported)

RTOL = 1e-10
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "pystencils_autodiff_tpu",
           "pystencils_autodiff_tpu_torch")

CHILD = textwrap.dedent("""
    import json, sys
    BLOCKED = {blocked!r}
    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
    sys.meta_path.insert(0, Block())
    import torch
    from chip_smoke import halo_copies, torch_only_load
    runs = json.load(open(sys.argv[1]))
    res = []
    for r in runs:
        primal, vjp, meta = torch_only_load(r["path"])
        data = torch.load(r["inputs"])
        ins, fn = list(data["inputs"]), primal.module()
        if meta["dynamic"]:
            k = meta["steps_per_call"]
            assert data["n_steps"] % k == 0
            for _ in range(data["n_steps"] // k):
                ins = list(fn(*ins))
            out = ins
        else:
            out = fn(*ins)
            out = list(out) if isinstance(out, (tuple, list)) else [out]
        grads = (list(vjp.module()(*data["inputs"], *data["cots"]))
                 if vjp is not None else [])
        res.append({{"out": out, "grads": grads,
                     "copies": [halo_copies(p) for p in (primal, vjp)
                                if p is not None]}})
    torch.save(res, sys.argv[2])
    print(json.dumps({{
        "blocked": sorted(m for m in sys.modules
                          if m.split(".")[0] in BLOCKED)}}))
""").format(blocked=BLOCKED)


@pytest.fixture(scope="session")
def launch_op():
    """The leaf op's library, built once a session (g++ against the
    running PyTorch; cached under build/torch_kernels/)."""
    return launch.launch_op_library()


def torch_only(tmp_path, runs):
    """Run ``runs`` ((artifact path, inputs, cotangents, n_steps) each) in
    a fresh process with the port, jax and the JAX package refused and no
    compiler on its PATH; their outputs, gradients and halo copies."""
    spec = []
    for i, (path, ins, cots, n_steps) in enumerate(runs):
        data = str(tmp_path / f"in{i}.pt")
        torch.save({"inputs": list(ins), "cots": list(cots),
                    "n_steps": n_steps}, data)
        spec.append({"path": path, "inputs": data})
    (tmp_path / "runs.json").write_text(json.dumps(spec))
    empty = tmp_path / "no_compilers"
    empty.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, PATH=str(empty))
    env.pop("CUDA_HOME", None)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(tmp_path / "runs.json"),
         str(tmp_path / "out.pt")], capture_output=True, text=True,
        env=env, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "blocked": []}
    return torch.load(str(tmp_path / "out.pt"))


def _close(got, ref, err_msg=""):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape, err_msg
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-300),
                               err_msg=err_msg)


def _equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert torch.equal(g, r.detach())


def _eager(f, ins, cots):
    """(outputs, gradients w.r.t. every input) of ``f`` eagerly."""
    xs = [t.clone().requires_grad_() for t in ins]
    out = f(*xs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return outs, list(torch.autograd.grad(outs, xs, cots))


# ---------------------------------------------------------------------------
# The op: fixed and symbolic shapes.

def _rand(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape)) for _ in range(n)]


def _op_case(tmp_path, spatial, shapes):
    op = heat_step_op(kappa_field=True, dtype="float64")
    f = op.torch_function()
    names = [fl.name for fl in op.forward_input_fields]
    path = str(tmp_path / "op.pt2")
    save_exported(export_op(op, spatial, dtype=F64, device="cpu"), path)
    runs, refs = [], []
    for i, shape in enumerate(shapes):
        ins = _rand(10 + i, shape, len(names))
        (cot,) = _rand(20 + i, shape, 1)
        runs.append((path, ins, [cot], None))
        refs.append((ins, cot, _eager(lambda *a: f(**dict(zip(names, a))),
                                      ins, [cot])))
    got = torch_only(tmp_path, runs)
    jf = jax_twin(op).jax_function(lowering="jnp")
    for g, (ins, cot, (e_out, e_grads)) in zip(got, refs):
        _equal(g["out"], e_out)
        _equal(g["grads"], e_grads)
        jout, pull = jax.vjp(lambda *a: jf(*a),
                             *[jnp.asarray(t.numpy()) for t in ins])
        _close(g["out"][0], jout)
        for gg, jg in zip(g["grads"], pull(jnp.asarray(cot.numpy()))):
            _close(gg, jg)


def test_torch_only_load_of_a_fixed_shape_op(tmp_path, launch_op):
    _op_case(tmp_path, (14, 12), [(14, 12)])


def test_torch_only_load_of_a_shape_polymorphic_op(tmp_path, launch_op):
    _op_case(tmp_path, ("n", "m"), [(14, 12), (23, 9)])


# ---------------------------------------------------------------------------
# Recorded programs: every fuse mode, and a step-count artifact.

def _heat_graphs(n, bc=True):
    """(port, JAX) graph datahandlings recording the (Neumann) heat sweep
    on the same seeded u, f64."""
    u = np.random.default_rng(n).standard_normal((n, n))
    pdh = GraphDataHandling((n - 2, n - 2), ghost_layers=1,
                            default_dtype=F64, device="cpu")
    jd = jgraph.GraphDataHandling((n - 2, n - 2), ghost_layers=1,
                                  default_dtype=jnp.float64)
    for dh, conv, op in ((pdh, torch.tensor,
                          heat_step_op(dt=0.1, dtype="float64")),
                         (jd, jnp.asarray, jheat(dt=0.1, kappa_field=False,
                                                 dtype="float64"))):
        dh.add_field("u")
        dh.set_array("u", conv(u))
        with dh.timeloop() as loop:
            if bc:
                loop.boundary({"u": "neumann"})
            loop.sweep(op, {"u": "u_next"})
    return pdh, jd


@pytest.mark.parametrize("fuse", ["none", "symbolic", "stages"])
def test_torch_only_load_of_a_recorded_program(tmp_path, launch_op, fuse):
    """``export_program`` over ``GraphDataHandling.compile`` in each fuse
    mode (the Neumann heat sweep; ``fuse="symbolic"`` without the BC,
    which it does not fuse), with its gradient."""
    n, steps = 16, 4
    pdh, jd = _heat_graphs(n, bc=fuse != "symbolic")
    kw = {"k": 2, "fused_bwd": True} if fuse == "stages" else {}
    run = pdh.compile(fuse=fuse, **kw)
    u = pdh.state()["u"]
    (cot,) = _rand(7, (n, n), 1)
    path = str(tmp_path / "prog.pt2")
    save_exported(export_program(run, pdh.state(), steps), path)
    (got,) = torch_only(tmp_path, [(path, [u], [cot], None)])
    e_out, e_grads = _eager(lambda a: run({"u": a}, steps)["u"], [u], [cot])
    _equal(got["out"], e_out)
    _equal(got["grads"], e_grads)
    jrun = jd.compile(lowering="jnp")
    _close(got["out"][0], jrun(jd.state(), steps)["u"])
    jg = jax.grad(lambda a: jnp.sum(jrun({"u": a}, steps)["u"]
                                    * jnp.asarray(cot.numpy())))(
        jd.state()["u"])
    _close(got["grads"][0], jg)


def test_torch_only_load_of_a_step_count_artifact(tmp_path, launch_op):
    """A step-count artifact (``n_steps=None``) of a ``fuse="stages"`` run
    (k=2): the loader runs ``n // steps_per_call`` calls, as
    ``ExportedOp`` does."""
    n = 16
    pdh, jd = _heat_graphs(n, bc=False)
    run = pdh.compile(fuse="stages", k=2)
    exp = export_program(run, pdh.state(), n_steps=None,
                         with_gradient=False)
    path = str(tmp_path / "dyn.pt2")
    save_exported(exp, path)
    assert json.loads(open(path + ".meta").read())["steps_per_call"] == 2
    u = pdh.state()["u"]
    got = torch_only(tmp_path, [(path, [u], [], 6)])
    _equal(got[0]["out"], [run({"u": u}, 6)["u"]])
    _close(got[0]["out"][0], jd.compile(lowering="jnp")(jd.state(), 6)["u"])


# ---------------------------------------------------------------------------
# The sidecar's checks.

def _saved(tmp_path):
    path = str(tmp_path / "art.pt2")
    save_exported(export_op(heat_step_op(dtype="float64"), (8, 7),
                            dtype=F64, device="cpu", with_gradient=False),
                  path)
    with open(path + ".meta") as fh:
        return path, json.load(fh)


def _write(path, meta):
    with open(path + ".meta", "w") as fh:
        json.dump(meta, fh)


def test_format_1_sidecar_raises(tmp_path, launch_op):
    """A sidecar of the pickled format raises, naming its format."""
    path, meta = _saved(tmp_path)
    _write(path, {"format": 1, "steps_per_call": 1, "dynamic": False,
                  "entries": {}})
    with pytest.raises(ValueError, match="format 1"):
        load_exported(path)


def test_library_outside_the_artifact_raises(tmp_path, launch_op):
    """A library named by a path outside the artifact's directory raises
    before anything is loaded, relative or absolute."""
    path, meta = _saved(tmp_path)
    lib = meta["libraries"][0]
    outside = tmp_path.parent / lib["file"]
    outside.write_bytes((tmp_path / lib["file"]).read_bytes())
    for name in (f"../{lib['file']}", str(outside)):
        lib["file"] = name
        _write(path, meta)
        with pytest.raises(ValueError, match="outside"):
            load_exported(path)


def test_tampered_library_raises(tmp_path, launch_op):
    """A library whose bytes differ from the sidecar's sha256 raises before
    anything is loaded."""
    path, meta = _saved(tmp_path)
    f = tmp_path / meta["libraries"][0]["file"]
    data = bytearray(f.read_bytes())
    data[len(data) // 2] ^= 0xFF
    f.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="sha256"):
        load_exported(path)


def test_library_that_does_not_load_raises(tmp_path, launch_op):
    """A kernel library whose bytes match the sidecar but which is no
    shared library raises where the leaf op opens it."""
    import hashlib

    path, meta = _saved(tmp_path)
    bad = tmp_path / "not_a_library.so"
    bad.write_bytes(b"not an ELF file")
    meta["libraries"].append({
        "file": bad.name, "sha256": hashlib.sha256(bad.read_bytes()
                                                   ).hexdigest(),
        "arch": launch.ARCH, "source": bad.name, "role": "kernel"})
    _write(path, meta)
    with pytest.raises(RuntimeError, match="cannot load"):
        load_exported(path)
