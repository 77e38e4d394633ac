"""The port stands alone: tpu_sage_torch and chip_smoke.py import neither JAX
nor anything of the JAX package, nor scikit-learn (the card's machine has
none)."""

import ast
import glob
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(glob.glob(os.path.join(REPO, "tpu_sage_torch", "**", "*.py"), recursive=True))
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|optax|sklearn)\b|from\s+(jax|flax|optax|sklearn)\b"
    r"|import\s+tpu_sage(\.|\s|$)|from\s+tpu_sage(\.|\s))",
    re.MULTILINE,
)


def test_importing_the_port_loads_no_jax_module():
    """Every module of the port (``train/unsupervised.py``, whose probe is
    written without scikit-learn, ``nn/fused.py``, the multi-device
    ``dist/`` modules and the auxiliary ones, the native library and the
    converter included) imports neither JAX nor the JAX package nor
    scikit-learn."""
    modules = sorted(
        "tpu_sage_torch." + os.path.relpath(p, os.path.join(REPO, "tpu_sage_torch"))[:-3]
        .replace(os.sep, ".").removesuffix(".__init__") for p in PORT_FILES)
    assert "tpu_sage_torch.train.unsupervised" in modules and "tpu_sage_torch.nn.fused" in modules
    assert {f"tpu_sage_torch.dist.{m}" for m in ("mesh", "partition", "halo", "train",
                                                   "data_parallel", "debug")} <= set(modules)
    assert {f"tpu_sage_torch.{m}" for m in ("native", "data.convert", "overrides", "utils",
                                            "bench.capacity", "bench.profile",
                                            "bench.torch_baseline")} <= set(modules)
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        "import tpu_sage_torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'tpu_sage', 'sklearn'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port imported: {out.stdout.strip()}"


@pytest.mark.parametrize("path", PORT_FILES + [os.path.join(REPO, "chip_smoke.py")],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_has_no_jax_or_reference_import(path):
    with open(path) as f:
        hits = FORBIDDEN.findall(f.read())
    assert not hits, f"{os.path.relpath(path, REPO)} imports {hits}"


def _code_strings(source):
    """The string constants of ``source`` that are not docstrings."""
    tree = ast.parse(source)
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [c.value for c in ast.walk(tree)
            if isinstance(c, ast.Constant) and isinstance(c.value, str) and id(c) not in docs]


JAX_PACKAGE_PATH = re.compile(r"tpu_sage(?!_torch)(/|$)")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_port_module_names_a_file_of_the_jax_package(path):
    """No module reaches the JAX package by path either: the C++ graph code and
    the fold codes are the port's own copies (``native/``, ``data/``)."""
    with open(path) as f:
        hits = [s for s in _code_strings(f.read()) if JAX_PACKAGE_PATH.search(s)]
    assert not hits, f"{os.path.relpath(path, REPO)} names {hits}"


def test_the_path_pattern_catches_what_it_should():
    assert _code_strings('"""doc tpu_sage/x.py"""\nx = "tpu_sage/native"\n') == ["tpu_sage/native"]
    for s in ("tpu_sage/native/graph_builder.cpp", "tpu_sage", "../tpu_sage/"):
        assert JAX_PACKAGE_PATH.search(s), s
    for s in ("tpu_sage_torch/native", "build/tpu_sage_torch", "tpu_sage_torch"):
        assert not JAX_PACKAGE_PATH.search(s), s


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import flax.linen as nn",
                 "from tpu_sage.ops import row_gather", "import tpu_sage",
                 "  from optax import adam", "from sklearn.linear_model import LogisticRegression"):
        assert FORBIDDEN.search(line), line
    for line in ("import tpu_sage_torch", "from tpu_sage_torch.ops import row_gather",
                 "# tpu_sage/kernels/select.py", "import jaxtyping_like_name_x"):
        assert not FORBIDDEN.search(line), line


def test_the_port_exports_the_reference_public_names():
    """``from tpu_sage_torch import GSSupervised`` works as it does from
    ``tpu_sage``: the same 12 names, each the port's counterpart."""
    import tpu_sage
    import tpu_sage_torch
    from tpu_sage_torch.nn.model import GSSupervised
    from tpu_sage_torch.sample.sampler import UniformNeighborSampler

    assert sorted(tpu_sage_torch.__all__) == sorted(tpu_sage.__all__)
    for name in tpu_sage.__all__:
        obj = getattr(tpu_sage_torch, name)
        assert obj.__module__.startswith("tpu_sage_torch.") if hasattr(obj, "__module__") \
            else isinstance(obj, dict), name
    assert tpu_sage_torch.GSSupervised is GSSupervised
    assert tpu_sage_torch.UniformNeighborSampler is UniformNeighborSampler
    with pytest.raises(AttributeError):
        tpu_sage_torch.no_such_name  # noqa: B018


def test_public_names_import_on_first_use():
    """``import tpu_sage_torch`` alone imports no submodule (the CLI's
    ``--help`` stays fast); the first access of a name imports its module."""
    code = (
        "import sys, tpu_sage_torch\n"
        "before = sorted(m for m in sys.modules if m.startswith('tpu_sage_torch.'))\n"
        "tpu_sage_torch.NodeProblem\n"
        "print(before, 'tpu_sage_torch.data.problem' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] True"
