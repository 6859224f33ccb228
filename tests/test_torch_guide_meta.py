"""The user guide's links, citations, migration table and generated API
reference hold:

- every relative link of ``docs/torch_port/`` resolves, and the index
  links every page;
- every ``module::name`` a page cites imports from the port (or, under
  ``tests/``, is defined there) and has a docstring;
- each row of the migration table behaves as written: **same** (the
  JAX package's meaning, held against it in float64), **ignored** or
  **raises** (the error named), for ``torch_function`` (or the chains,
  for ``reads``) and ``LoweringConfig``;
- every measured number stands beside the card's name and power limit,
  and no TPU figure appears;
- ``tools/gen_api_docs_torch.py`` run twice with ``jax`` and the JAX
  package blocked reproduces ``docs/torch_port/api/`` byte for byte."""

import ast
import importlib
import inspect
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from chip_smoke import GUIDE_DIR, GUIDE_PAGES

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = "pystencils_autodiff_tpu_torch"
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def page_text(page):
    return (GUIDE_DIR / f"{page}.md").read_text()


def guide_files():
    return [GUIDE_DIR / f"{p}.md" for p in GUIDE_PAGES] + [
        GUIDE_DIR / "api" / "index.md"]


# -- links ------------------------------------------------------------------

LINK = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")


def prose(text):
    """``text`` without its code blocks and inline code."""
    text = re.sub(r"^```.*?^```", "", text, flags=re.S | re.M)
    return re.sub(r"`[^`]*`", "", text)


@pytest.mark.parametrize("path", guide_files(), ids=lambda p: p.name)
def test_every_relative_link_resolves(path):
    links = [t for t in LINK.findall(prose(path.read_text()))
             if not re.match(r"[a-z]+:", t)]
    missing = [t for t in links
               if not (path.parent / t.split("#")[0]).resolve().exists()]
    assert not missing, f"{path.name}: unresolved links {missing}"


def test_index_links_every_page_and_the_api_reference():
    links = set(LINK.findall(prose(page_text("index"))))
    want = {f"{p}.md" for p in GUIDE_PAGES if p != "index"} | {
        "api/index.md"}
    assert want <= links, sorted(want - links)


# -- citations --------------------------------------------------------------

CITE = re.compile(r"`([\w/]+)\.py::([A-Za-z_][\w.]*)")


def citations():
    out = set()
    for p in GUIDE_PAGES:
        for path, name in CITE.findall(page_text(p)):
            out.add((path, name))
    return sorted(out)


def _resolve(path, name):
    """The object ``name`` (dotted within its module) cites."""
    obj = importlib.import_module(f"{PORT}." + path.replace("/", "."))
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def test_the_guide_cites_the_port_by_module_and_function():
    assert len(citations()) >= 20, citations()


@pytest.mark.parametrize("path, name", citations(),
                         ids=lambda v: str(v))
def test_cited_name_imports_and_has_a_docstring(path, name):
    if path.startswith("tests/"):
        tree = ast.parse((ROOT / f"{path}.py").read_text())
        defs = {n.name: n for n in ast.walk(tree)
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
        assert name in defs, f"{path}.py defines no {name}"
        assert ast.get_docstring(defs[name]), f"{path}.py::{name}"
        return
    obj = _resolve(path, name)
    assert inspect.getdoc(obj), f"{path}.py::{name} has no docstring"


# -- the migration table ----------------------------------------------------

def migration_rows():
    """``{keyword: (torch_function verdict, LoweringConfig verdict)}``."""
    rows = {}
    for line in page_text("migration").splitlines():
        m = re.match(r"\| `(\w+)` \| ([^|]+) \| ([^|]+) \|", line)
        if m:
            rows[m.group(1)] = (m.group(2).strip(), m.group(3).strip())
    return rows


KEYWORDS = ("lowering", "strategy", "tile_rows", "interpret", "dtype",
            "vmem_limit_bytes", "full_domain", "accumulate", "periodic",
            "reads")
# a value of each keyword that means something in the JAX package
VALUE = {"lowering": "pallas", "strategy": "tiled", "tile_rows": 8,
         "interpret": True, "dtype": "float64",
         "vmem_limit_bytes": 1 << 26, "full_domain": True,
         "accumulate": "dd", "periodic": True, "reads": "slice"}


def test_the_migration_table_has_a_row_per_keyword():
    assert set(migration_rows()) == set(KEYWORDS)


def _heat():
    from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, fields

    u, out, kappa = fields("u, out, kappa", 2)
    return AutoDiffOp([Assignment(
        out.center, u[0, 0] + 0.1 * kappa[0, 0] * (
            u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1] - 4 * u[0, 0]))],
        op_name="heat_migration")


def _inputs(op, shape, seed=21):
    rng = np.random.default_rng(seed)
    return {f.name: rng.random(shape) for f in op.forward_input_fields}


def _port_value_and_grad(op, arrays, **kw):
    x = {n: torch.tensor(a, requires_grad=True) for n, a in arrays.items()}
    y = op.torch_function(**kw)(**x)
    y.square().sum().backward()
    return y.detach().numpy(), {n: t.grad.numpy() for n, t in x.items()}


def _jax_value_and_grad(op, arrays, lowering="jnp", **kw):
    import jax
    import jax.numpy as jnp
    from torch_jax_twin import jax_twin

    f = jax_twin(op).jax_function(lowering=lowering, **kw)
    names = sorted(arrays)
    y = f(**arrays)
    grads = jax.grad(lambda *a: jnp.sum(f(**dict(zip(names, a))) ** 2),
                     argnums=tuple(range(len(names))))(
        *[arrays[n] for n in names])
    return np.asarray(y), {n: np.asarray(g) for n, g in zip(names, grads)}


def _same_as_jax(op, arrays, kw, lowering="jnp", jax_kw=None):
    y, g = _port_value_and_grad(op, arrays, **kw)
    jy, jg = _jax_value_and_grad(op, arrays, lowering, **(jax_kw or kw))
    assert y.dtype == jy.dtype, (y.dtype, jy.dtype)
    np.testing.assert_allclose(y, jy, rtol=1e-10, atol=1e-12)
    for n in g:
        # a gradient is in its input's type (float32 inputs: rounded once)
        tol = 1e-10 if g[n].dtype == np.float64 else 1e-6
        np.testing.assert_allclose(g[n], jg[n], rtol=tol, atol=tol * 1e-2)


def _torch_function_same(kw):
    """``torch_function`` with the keyword against ``jax_function`` with it
    (float64, the jnp lowering; the tiled strategy against the JAX
    package's Pallas tiled path in interpret mode)."""
    op, value = _heat(), VALUE[kw]
    arrays = _inputs(op, (24, 20))
    if kw in ("strategy", "tile_rows"):
        both = {"strategy": "tiled", "tile_rows": 8}
        _same_as_jax(op, arrays, both, lowering="pallas")
        from pystencils_autodiff_tpu_torch.models import upwind1_op
        with pytest.raises(ValueError):        # the tiled path takes 2+ dims
            upwind1_op().torch_function(strategy="tiled")
    elif kw == "dtype":
        # the meaning of the Pallas lowering, which casts its inputs (the
        # jnp lowering computes in the inputs' type and casts its outputs)
        f32 = {n: a.astype(np.float32) for n, a in arrays.items()}
        _same_as_jax(op, f32, {"dtype": torch.float64}, lowering="pallas",
                     jax_kw={"dtype": "float64"})
        y = op.torch_function(dtype=value)(
            **{n: torch.tensor(a) for n, a in f32.items()})
        assert y.dtype == torch.float64
    elif kw == "accumulate":
        from pystencils_autodiff_tpu_torch.models import anisotropic27_op
        aniso = anisotropic27_op(dtype="float64")
        _same_as_jax(aniso, _inputs(aniso, (10, 9, 8)), {"accumulate": "dd"})
        with pytest.raises(ValueError):
            op.torch_function(accumulate="kahan")
    elif kw == "periodic":
        _same_as_jax(op, arrays, {"periodic": True})
    else:
        raise AssertionError(f"no 'same' check for {kw}")


def _config_same(kw):
    """``LoweringConfig`` carries the keyword into ``torch_function``."""
    from pystencils_autodiff_tpu_torch.utils import LoweringConfig

    value = {"dtype": torch.float64}.get(kw, VALUE[kw])
    cfg = LoweringConfig(**{kw: value})
    assert cfg.kwargs()[kw] == value
    op = _heat()
    x = {n: torch.tensor(a) for n, a in _inputs(op, (24, 20)).items()}
    kw_all = {kw: value}
    if kw == "tile_rows":
        cfg = LoweringConfig(strategy="tiled", tile_rows=value)
        kw_all = {"strategy": "tiled", "tile_rows": value}
    torch.testing.assert_close(op.torch_function(config=cfg)(**x),
                               op.torch_function(**kw_all)(**x),
                               rtol=0, atol=0)


def _raises(kw, error, where):
    op = _heat()
    if where == "config":
        from pystencils_autodiff_tpu_torch.utils import LoweringConfig
        with pytest.raises(error):
            LoweringConfig(**{kw: VALUE[kw]})
    elif kw == "reads":
        from pystencils_autodiff_tpu_torch.ops import (fused_chain_vjp,
                                                       fused_time_chain)
        for build in (fused_time_chain, fused_chain_vjp):
            with pytest.raises(error):
                build(op, 2, {"u": "out"}, reads=VALUE[kw])
    else:
        with pytest.raises(error):
            op.torch_function(**{kw: VALUE[kw]})


def _config_ignored(kw):
    """The field is kept and left out of ``kwargs()``, as in the JAX
    package; the op's result does not change."""
    from pystencils_autodiff_tpu.utils.config import \
        LoweringConfig as JaxConfig

    from pystencils_autodiff_tpu_torch.utils import LoweringConfig

    cfg = LoweringConfig(**{kw: VALUE[kw]})
    assert getattr(cfg, kw) == VALUE[kw] and kw not in cfg.kwargs()
    assert kw not in JaxConfig(**{kw: VALUE[kw]}).kwargs()
    op = _heat()
    x = {n: torch.tensor(a) for n, a in _inputs(op, (24, 20)).items()}
    torch.testing.assert_close(op.torch_function(config=cfg)(**x),
                               op.torch_function()(**x), rtol=0, atol=0)


def _not_a_field(kw):
    """Neither package's ``LoweringConfig`` has the field."""
    from pystencils_autodiff_tpu.utils.config import \
        LoweringConfig as JaxConfig

    from pystencils_autodiff_tpu_torch.utils import LoweringConfig

    for cls in (LoweringConfig, JaxConfig):
        with pytest.raises(TypeError):
            cls(**{kw: VALUE[kw]})


def _check(verdict, kw, where):
    if verdict == "same":
        (_torch_function_same if where == "function" else _config_same)(kw)
    elif verdict == "ignored":
        assert where == "config", f"{kw}: 'ignored' is a config verdict here"
        _config_ignored(kw)
    elif verdict == "—":
        assert where == "config"
        _not_a_field(kw)
    else:
        m = re.fullmatch(r"raises (\w+)", verdict)
        assert m, f"{kw}: unknown verdict {verdict!r}"
        _raises(kw, {"TypeError": TypeError,
                     "ValueError": ValueError}[m.group(1)], where)


@pytest.mark.parametrize("kw", KEYWORDS)
def test_migration_row_behaves_as_written(kw):
    fn_verdict, cfg_verdict = migration_rows()[kw]
    _check(fn_verdict, kw, "function")
    _check(cfg_verdict, kw, "config")


# -- numbers ----------------------------------------------------------------

MEASURED = re.compile(r"\d[\d.,]*\s*(ms|µs|TFLOP/s|TB/s|GB/s|GLUPS|s a)\b")


@pytest.mark.parametrize("page", GUIDE_PAGES)
def test_every_number_names_the_card_and_none_is_a_tpu_figure(page):
    text = page_text(page)
    assert "v5e" not in text and "TPU v" not in text
    chunks = [c for c in re.split(r"\n\s*\n", text)]
    rows = [line for c in chunks for line in c.splitlines()
            if line.startswith("|")]
    prose = [c for c in chunks if not c.lstrip().startswith("|")]
    for chunk in rows + prose:
        if MEASURED.search(chunk):
            assert "NVIDIA H100 80GB HBM3" in chunk and "700.00 W" in chunk, \
                f"{page}.md: a number without the card: {chunk[:120]!r}"


# -- the API reference ------------------------------------------------------

def _generate(out):
    script = textwrap.dedent(f"""
        import runpy, sys
        BLOCKED = ("jax", "jaxlib", "pystencils_autodiff_tpu")
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        sys.argv = ["gen_api_docs_torch.py", "--out", {str(out)!r}]
        runpy.run_path({str(ROOT / "tools" / "gen_api_docs_torch.py")!r},
                       run_name="__main__")
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


def test_api_reference_regenerates_byte_for_byte_without_jax(tmp_path):
    checked_in = GUIDE_DIR / "api"
    runs = []
    for name in ("a", "b"):
        out = tmp_path / name
        stdout = _generate(out)
        assert re.search(r"^\d+ public entries without a docstring$",
                         stdout, re.M), stdout[:500]
        runs.append({p.name: p.read_bytes() for p in out.glob("*.md")})
    assert runs[0] == runs[1], "two runs of the generator differ"
    want = {p.name: p.read_bytes() for p in checked_in.glob("*.md")}
    assert sorted(runs[0]) == sorted(want), "the pages differ"
    differ = [n for n in want if runs[0][n] != want[n]]
    assert not differ, f"regenerate docs/torch_port/api: {differ}"
    assert not any(re.search(rb" at 0x[0-9a-f]+", b) for b in want.values())
