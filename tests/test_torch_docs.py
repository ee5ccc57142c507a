"""The port's reference pages (``docs/torch/``) against the port, on the
CPU and without Sphinx.

No Sphinx here: the pages are read as text.  Every autodoc directive's
target (and each name of an explicit ``:members:`` list) must import from
``pytorch_nmf_tpu_torch`` and resolve; every name of the public modules'
``__all__`` must be documented; every page must be reached from a toctree
of ``index.rst``; every Python code block must parse and its imports of the
port resolve; every cross reference must name a page or an object that
exists; and the performance page carries only figures that name the card
and its power limit.
"""

import ast
import importlib
import re
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
DOCS = ROOT / "docs" / "torch"
PAGES = sorted(p.relative_to(DOCS).with_suffix("").as_posix()
               for p in DOCS.rglob("*.rst"))
PUBLIC = ("nmf", "plca", "metrics", "trainer", "functional", "parallel",
          "utils")
DIRECTIVE = re.compile(r"^\.\. (automodule|autoclass|autofunction)::\s*(\S+)"
                       r"((?:\n   .*)*)", re.M)
CARD = "H100 80GB HBM3, 700 W"


def _text(page):
    return (DOCS / f"{page}.rst").read_text()


def _resolve(dotted):
    """The object a dotted name names: the longest importable module
    prefix, then attributes."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for name in parts[i:]:
            obj = getattr(obj, name)
        return obj
    raise ImportError(dotted)


def _directives():
    """``[(page, kind, target, members)]``: ``members`` ``None`` without a
    ``:members:`` option, ``()`` for all of them, else the listed names."""
    out = []
    for page in PAGES:
        for m in DIRECTIVE.finditer(_text(page)):
            kind, target, opts = m.groups()
            members = None
            opt = re.search(r":members:(.*(?:\n {13,}.*)*)", opts)
            if opt:
                members = tuple(n for n in re.split(r"[,\s]+", opt.group(1))
                                if n)
            out.append((page, kind, target, members))
    return out


DIRECTIVES = _directives()


def _code_blocks():
    out = []
    for page in PAGES:
        lines = _text(page).split("\n")
        for i, line in enumerate(lines):
            if line.strip() == ".. code-block:: python":
                body = []
                for nxt in lines[i + 1:]:
                    if nxt.strip() and not nxt.startswith(" "):
                        break
                    body.append(nxt)
                out.append((f"{page}:{i + 1}",
                            textwrap.dedent("\n".join(body)).strip()))
    return out


CODE = _code_blocks()


def test_the_tree_has_every_page():
    assert (DOCS / "conf.py").is_file()
    assert [p for p in PAGES if p.startswith("modules/")] == [
        f"modules/{m}" for m in sorted(
            ("nmf", "plca", "metrics", "trainer", "parallel", "functional",
             "ops", "utils"))]
    assert [p for p in PAGES if p.startswith("notes/")] == [
        "notes/hopper_design", "notes/intro", "notes/migration",
        "notes/performance"]
    assert "index" in PAGES


def _conf(path):
    """The literal assignments of a Sphinx ``conf.py``."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def test_conf_names_the_port_with_the_jax_pages_extensions():
    port, jax = _conf(DOCS / "conf.py"), _conf(ROOT / "docs/source/conf.py")
    assert port["project"] == "pytorch_nmf_tpu_torch"
    assert port["extensions"] == jax["extensions"]
    assert port["html_theme"] == jax["html_theme"]


@pytest.mark.parametrize("page, kind, target, members", DIRECTIVES,
                         ids=[f"{d[0]}:{d[2]}" for d in DIRECTIVES])
def test_autodoc_targets_resolve(page, kind, target, members):
    assert target.startswith("pytorch_nmf_tpu_torch.") \
        or target == "pytorch_nmf_tpu_torch"
    obj = _resolve(target)
    if kind == "automodule":
        assert obj.__name__ == target
    else:
        assert callable(obj)
    for name in members or ():
        assert hasattr(obj, name), f"{target}.{name}"


def test_no_directive_names_the_jax_package():
    text = "\n".join(_text(p) for p in PAGES)
    for m in re.finditer(r"(?:\.\. auto\w+::|:members:)\s*(.*)", text):
        assert not re.search(r"\bpytorch_nmf_tpu(?!_torch)\b", m.group(1))
    for m in re.finditer(r":(?:mod|func|class|meth|data|attr):`~?([^`]+)`",
                         text):
        assert re.match(r"pytorch_nmf_tpu_torch\b", m.group(1)), m.group(0)


def _documented():
    """The objects the pages document: every directive's target, an
    automodule's ``__all__`` under a bare ``:members:``, and the listed
    members."""
    ids = set()
    for _, kind, target, members in DIRECTIVES:
        obj = _resolve(target)
        ids.add(id(obj))
        if members == () and kind == "automodule":
            names = getattr(obj, "__all__", ())
        else:
            names = members or ()
        ids |= {id(getattr(obj, n)) for n in names}
    return ids


@pytest.mark.parametrize("module", PUBLIC)
def test_every_public_name_is_documented(module):
    mod = importlib.import_module(f"pytorch_nmf_tpu_torch.{module}")
    documented = _documented()
    missing = [n for n in mod.__all__ if id(getattr(mod, n)) not in documented]
    assert not missing


def _toctree_entries(page):
    out = []
    for m in re.finditer(r"^\.\. toctree::\n((?:   .*\n|\n)*)", _text(page),
                         re.M):
        for line in m.group(1).splitlines():
            line = line.strip()
            if line and not line.startswith(":"):
                base = str(Path(page).parent / line)
                out.append(base[2:] if base.startswith("./") else base)
    return out


def test_every_page_is_reached_from_a_toctree():
    seen, todo = {"index"}, ["index"]
    while todo:
        for entry in _toctree_entries(todo.pop()):
            assert entry in PAGES, entry
            if entry not in seen:
                seen.add(entry)
                todo.append(entry)
    assert seen == set(PAGES)


@pytest.mark.parametrize("where, code", CODE, ids=[c[0] for c in CODE])
def test_code_blocks_parse_and_their_imports_resolve(where, code):
    tree = ast.parse(code)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith("pytorch_nmf_tpu_torch"):
                    importlib.import_module(alias.name)
        elif isinstance(node, ast.ImportFrom) and (
                node.module or "").startswith("pytorch_nmf_tpu_torch"):
            mod = importlib.import_module(node.module)
            for alias in node.names:
                assert hasattr(mod, alias.name) or importlib.import_module(
                    f"{node.module}.{alias.name}"), (where, alias.name)
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] + [
                getattr(node, "module", None) or ""]
            assert not any(re.match(r"(jax|pytorch_nmf_tpu)(\.|$)", n)
                           for n in names), (where, names)


@pytest.mark.parametrize("page", PAGES)
def test_cross_references_resolve(page):
    text = _text(page)
    for m in re.finditer(r":doc:`([^`<]+?)`", text):
        target = (Path(page).parent / m.group(1)).as_posix()
        parts = []
        for p in target.split("/"):
            if p == "..":
                parts.pop()
            elif p != ".":
                parts.append(p)
        assert "/".join(parts) in PAGES, m.group(0)
    for m in re.finditer(r":(?:mod|func|class|meth|data|attr):`~?([^`]+)`",
                         text):
        _resolve(m.group(1))


@pytest.mark.parametrize("page", PAGES)
def test_simple_tables_keep_to_their_columns(page):
    """In a simple table a row's first cell is one line (text under the
    first column would start a new row), and no text crosses a gap
    between columns but into the last."""
    lines = _text(page).split("\n")
    border = re.compile(r"^=+(  +=+)+$")
    i = 0
    while i < len(lines):
        if not border.match(lines[i]):
            i += 1
            continue
        spans = [m.span() for m in re.finditer(r"=+", lines[i])]
        j = i + 1
        ends = 0
        while ends < 2:
            line = lines[j]
            if border.match(line):
                assert [m.span() for m in re.finditer(r"=+", line)] == spans
                ends += 1
            else:
                for (_, end), (start, _) in zip(spans, spans[1:]):
                    assert line[end:start].strip() == "", (page, j + 1, line)
            j += 1
        i = j


def test_performance_page_holds_card_figures_only():
    text = _text("notes/performance")
    assert "TPU" not in text and "v5e" not in text
    rows = [line for line in text.splitlines()
            if re.match(r"^[^ =].*\d\.\d", line) and "  " in line]
    assert rows
    for line in rows:
        assert CARD in line and re.search(r"PRs? \d", line), line
    for para in re.split(r"\n\n", text):
        if re.search(r"\d\.\d+e-\d|\d\.\d{2,} ms", para):
            assert "H100 80GB HBM3, 700 W" in para.replace("\n", " ")
