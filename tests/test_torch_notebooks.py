"""The port's tutorial notebooks (``examples/torch_port/*.ipynb``) against
their generator and scripts, on the CPU.

The committed notebooks were executed on the card by
``examples/torch_port/make_notebooks.py``.  Here the generator's split of
each script must equal the committed cells (a script edit that forgets the
notebook fails), its ``--device cpu`` run must write valid nbformat-4
notebooks, and the numbers those print must agree with the committed card
outputs within ``make_notebooks.RTOL`` relative plus one unit of the last
printed digit, integers equal (the device line left out): the card's
3xTF32 kernels and cuBLAS against the CPU's f32 loops, another summation
order, within the 1e-3 the examples hold card against CPU.  Neither the
generator nor the notebooks import JAX or the JAX package.
"""

import ast
import importlib.util
import json
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "examples" / "torch_port"
NAMES = ("basic_tutorial", "source_filter_model")
# blocks JAX and the JAX package, then runs the generator as its command
# line does
CLI = """
import runpy, sys
for name in ("jax", "pytorch_nmf_tpu"):
    sys.modules[name] = None
sys.argv = [sys.argv[1], "--device", "cpu", "--out", sys.argv[2]]
runpy.run_path(sys.argv[0], run_name="__main__")
for name, mod in sys.modules.items():
    assert mod is None or not (name in ("jax", "pytorch_nmf_tpu")
                               or name.startswith(("jax.", "pytorch_nmf_tpu."))), name
"""


@pytest.fixture(scope="module")
def nbm():
    spec = importlib.util.spec_from_file_location(
        "torch_port_make_notebooks", HERE / "make_notebooks.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """The generator's ``--device cpu`` run into a temporary directory,
    with JAX and the JAX package blocked."""
    out = tmp_path_factory.mktemp("notebooks")
    r = subprocess.run([sys.executable, "-c", CLI,
                        str(HERE / "make_notebooks.py"), str(out)],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return out


def _committed(name):
    with open(HERE / f"{name}.ipynb") as f:
        return json.load(f)


@pytest.mark.parametrize("name", NAMES)
def test_split_equals_committed_cells(nbm, name):
    doc, cells = nbm.split_script(HERE / f"{name}.py", "cuda")
    nb = _committed(name)
    title = "".join(nb["cells"][0]["source"])
    assert title.startswith(f"# {doc}\n\nExecuted on ")
    committed = [(c[0], c[1]) for c in nbm.read_notebook(HERE / f"{name}.ipynb")]
    assert committed == cells


@pytest.mark.parametrize("name", NAMES)
def test_committed_notebook_was_executed_on_the_card(nbm, name):
    """The title names the card and its power limit as ``nvidia-smi``
    gives them; the setup cell printed the card's name; every code cell
    that prints printed something."""
    nb = _committed(name)
    last = "".join(nb["cells"][0]["source"]).splitlines()[-1]
    assert last.startswith("Executed on NVIDIA ")
    assert " W (`nvidia-smi` name, power limit)." in last
    cells = nbm.read_notebook(HERE / f"{name}.ipynb")
    setup = cells[0][2].splitlines()
    assert setup == [nbm.DEVICE + last[len("Executed on "):].split(",")[0]]
    printing = [out for kind, src, out in cells
                if kind == "code" and "print(" in src]
    assert len(printing) >= 2 and all(printing)


@pytest.mark.parametrize("committed", [False, True], ids=["cpu", "committed"])
@pytest.mark.parametrize("name", NAMES)
def test_notebook_is_valid_nbformat4(cpu_run, name, committed):
    """The CPU run's notebook and the committed one: nbformat 4.5, cell
    ids unique, stdout streams only."""
    with open((HERE if committed else cpu_run) / f"{name}.ipynb") as f:
        nb = json.load(f)
    assert nb["nbformat"] == 4 and nb["nbformat_minor"] == 5
    assert nb["metadata"]["kernelspec"]["name"] == "python3"
    assert nb["cells"][0]["cell_type"] == "markdown"
    ids = [cell["id"] for cell in nb["cells"]]
    assert len(set(ids)) == len(ids)
    for cell in nb["cells"]:
        assert isinstance(cell["metadata"], dict)
        assert all(isinstance(line, str) for line in cell["source"])
        if cell["cell_type"] == "code":
            assert cell["execution_count"] is None
            for out in cell["outputs"]:
                assert out["output_type"] == "stream"
                assert out["name"] == "stdout"
        else:
            assert cell["cell_type"] == "markdown"
            assert "outputs" not in cell
    nbformat = pytest.importorskip("nbformat")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a missing cell id only warns
        nbformat.validate(nbformat.reads(json.dumps(nb), as_version=4))


@pytest.mark.parametrize("name", NAMES)
def test_cpu_numbers_agree_with_the_card(nbm, cpu_run, name):
    got = nbm.read_notebook(cpu_run / f"{name}.ipynb")
    want = nbm.read_notebook(HERE / f"{name}.ipynb")
    assert [c[0] for c in got] == [c[0] for c in want]
    assert got[0][2] == "device: cpu\n"
    for i, (g, w) in enumerate(zip(got, want)):
        if g[0] == "code":
            assert nbm.compare_outputs(g[2], w[2]) is None, (i, g[2], w[2])


@pytest.mark.parametrize("printed, committed, agree", [
    ("KL = 339.4024\n", "KL = 339.402\n", True),
    ("KL = 339.80\n", "KL = 339.402\n", False),   # past 1e-3 plus 0.001
    ("in 170 iterations\n", "in 180 iterations\n", False),
    ("(128, 24)\n", "(128, 24)\n", True),
    ("step 10: x\n", "stop 10: x\n", False),
    ("a\nb\n", "a\n", False),
    ("device: cpu\nx 1\n", "device: NVIDIA H100\nx 1\n", True),
])
def test_compare_outputs(nbm, printed, committed, agree):
    assert (nbm.compare_outputs(printed, committed) is None) == agree


def test_default_device_without_a_card_raises(nbm, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nbm.main(out=str(tmp_path))
    assert not list(tmp_path.iterdir())


def _imports(src):
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", ["make_notebooks.py"]
                         + [f"{n}.ipynb" for n in NAMES])
def test_no_jax_imports(nbm, path):
    if path.endswith(".py"):
        srcs = [(HERE / path).read_text()]
    else:
        srcs = [s for kind, s, _ in nbm.read_notebook(HERE / path)
                if kind == "code"]
    names = set().union(*map(_imports, srcs))
    assert names, path
    assert not {n for n in names if n == "jax" or n.startswith("jax.")
                or n == "pytorch_nmf_tpu"
                or n.startswith("pytorch_nmf_tpu.")}
