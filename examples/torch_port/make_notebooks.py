"""Generate the executed notebooks of the port's tutorials, on the card.

The PyTorch/CUDA port's counterpart of ``examples/make_notebooks.py``: the
runnable scripts in this directory stay the source of truth, and
``basic_tutorial.ipynb`` and ``source_filter_model.ipynb`` are derived
from ``basic_tutorial.py`` and ``source_filter_model.py``.

Conversion rules (the scripts share one layout):

* the module docstring, without its ``Run:`` line -> the title markdown
  cell, which names the device the cells were executed on (on the card,
  its name and power limit as ``nvidia-smi --query-gpu=name,power.limit
  --format=csv,noheader`` gives them);
* the imports and definitions before ``def main`` -> the setup code cell,
  without ``argparse`` (the ``__main__`` block stays out), the repo-root
  path shim pointed at ``../..`` (the notebooks run from this directory),
  and ending in ``device = ...``, which ``main``'s body reads, and a line
  that prints the device;
* ``main``'s body, without its closing ``return`` -> code cells split on
  ``# --- section ---`` comments, each preceded by a markdown cell with the
  section's title (a script without markers gives one cell).

Each code cell is executed in one namespace, from this directory, with its
standard output captured, so the notebooks carry real outputs.  The cells
run on the card unless ``--device cpu`` asks for the CPU; with no CUDA
device the default raises rather than running on the CPU.

Run:  python examples/torch_port/make_notebooks.py [--device cpu] [--out DIR]
"""

import argparse
import ast
import contextlib
import io
import json
import os
import re
import subprocess
import textwrap

HERE = os.path.dirname(os.path.abspath(__file__))
SCRIPTS = ("basic_tutorial.py", "source_filter_model.py")
SHIM = 'sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))'
DEVICE = "device: "  # the setup cell's printed device line
# a number as the cells print it: an integer, or a decimal to some digits
NUMBER = re.compile(r"[-+]?\d+(?:\.(\d+))?(?:[eE][-+]?\d+)?")
# the tolerance of a printed decimal against the committed one: RTOL of it,
# plus one unit of its last printed digit.  The committed outputs come from
# the card; a run on the CPU (3xTF32 kernels and cuBLAS there, f32 loops
# here: another summation order) or on a card whose libraries pick other
# algorithms moves the fits' numbers by f32 reordering, which the examples
# hold within 1e-3 card against CPU (``chip_smoke.EXAMPLE_RTOL``).
# Integers (iteration counts, non-zeros, shapes) are equal.
RTOL = 1e-3


def device_cell(device):
    """The setup cell's last lines: ``device``, and the line that prints
    the device the cells run on."""
    return (f'device = "{device}"  # "cpu" runs the same cells on the host\n'
            'print("device:", torch.cuda.get_device_name(device)\n'
            '      if device == "cuda" else "cpu")')


def split_script(path, device="cuda"):
    """``(doc, cells)``: the script's docstring without its ``Run:`` line,
    and its ``[(kind, source)]`` cells, ``kind`` ``"code"`` or
    ``"markdown"``."""
    with open(path) as f:
        src = f.read()
    tree = ast.parse(src)
    lines = src.split("\n")

    doc = ast.get_docstring(tree) or ""
    doc = re.sub(r"\n*Run:.*$", "", doc, flags=re.S).strip()

    main_fn = next(n for n in tree.body
                   if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = main_fn.body
    if isinstance(body[-1], ast.Return):  # main's numbers, for the tests
        body = body[:-1]
    body_src = textwrap.dedent("\n".join(
        lines[body[0].lineno - 1:body[-1].end_lineno]))

    first = tree.body[0]
    setup_start = first.end_lineno if isinstance(first, ast.Expr) else 0
    setup = "\n".join(
        line.replace("  # noqa: E402", "")
        for line in lines[setup_start:main_fn.lineno - 1]
        if line != "import argparse")
    if SHIM not in setup:
        raise ValueError(f"{path}: no repo-root path shim ({SHIM})")
    setup = setup.replace(SHIM, 'sys.path.insert(0, "../..")')
    setup = textwrap.dedent(setup).strip() + "\n\n" + device_cell(device)

    cells = [("code", setup)]
    current = []
    for line in body_src.split("\n"):
        m = re.match(r"\s*# --- (.*?) -*$", line)
        if m:
            if "\n".join(current).strip():
                cells.append(("code", "\n".join(current).strip()))
            current = []
            cells.append(("markdown", "### " + m.group(1).strip()))
        else:
            current.append(line)
    if "\n".join(current).strip():
        cells.append(("code", "\n".join(current).strip()))
    return doc, cells


def execute_cells(cells, cwd):
    """``[(kind, source, stdout)]``: the code cells run in turn in one
    namespace from ``cwd`` (stdout ``None`` for a markdown cell)."""
    ns = {"__name__": "__main__"}
    out = []
    old = os.getcwd()
    os.chdir(cwd)
    try:
        for kind, src in cells:
            if kind == "markdown":
                out.append((kind, src, None))
                continue
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                exec(compile(src, "<cell>", "exec"), ns)
            out.append((kind, src, buf.getvalue()))
    finally:
        os.chdir(old)
    return out


def executed_on(device):
    """The title cell's line naming where the cells ran."""
    if device == "cpu":
        return "Executed on the CPU (`--device cpu`)."
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return f"Executed on {card} (`nvidia-smi` name, power limit)."


def read_notebook(path):
    """``[(kind, source, stdout)]``: a notebook's cells after its title
    (stdout ``None`` for a markdown cell, ``""`` for a silent code cell)."""
    with open(path) as f:
        nb = json.load(f)
    out = []
    for c in nb["cells"][1:]:
        text = "".join(
            "".join(o["text"]) for o in c.get("outputs", ())
            if o.get("output_type") == "stream" and o.get("name") == "stdout")
        out.append((c["cell_type"], "".join(c["source"]),
                    text if c["cell_type"] == "code" else None))
    return out


def compare_outputs(got, want, rtol=RTOL):
    """``None`` when a cell's printed text ``got`` agrees with ``want``:
    the same lines, the same text between the numbers, integers equal and
    decimals within ``rtol`` of the wanted value plus one unit of its last
    printed digit; else the first difference.  Device lines (``DEVICE``)
    are left out."""
    gl, wl = ([line for line in text.splitlines()
               if not line.startswith(DEVICE)] for text in (got, want))
    if len(gl) != len(wl):
        return f"{len(gl)} lines printed, {len(wl)} committed"
    for g, w in zip(gl, wl):
        if NUMBER.sub("#", g) != NUMBER.sub("#", w):
            return f"line {g!r}, committed {w!r}"
        gn, wn = list(NUMBER.finditer(g)), list(NUMBER.finditer(w))
        for a, b in zip(gn, wn):
            x, y = float(a.group()), float(b.group())
            digits = b.group(1)
            tol = (rtol * abs(y) + 10.0 ** -len(digits)) if digits else 0.0
            if not abs(x - y) <= tol:
                return f"{x} in {g!r}, committed {y} (tolerance {tol:.3g})"
    return None


def to_notebook(title_md, cells):
    """An nbformat-4.5 notebook of the title cell and executed ``cells``,
    each cell's id its position (``cell-0`` the title), so that a notebook
    written again differs only where its cells do."""
    nb_cells = [{"cell_type": "markdown", "metadata": {},
                 "source": title_md.splitlines(keepends=True)}]
    for kind, src, out in cells:
        if kind == "markdown":
            nb_cells.append({"cell_type": "markdown", "metadata": {},
                             "source": src.splitlines(keepends=True)})
            continue
        outputs = []
        if out:
            outputs.append({"output_type": "stream", "name": "stdout",
                            "text": out.splitlines(keepends=True)})
        nb_cells.append({"cell_type": "code", "execution_count": None,
                         "metadata": {},
                         "source": src.splitlines(keepends=True),
                         "outputs": outputs})
    for i, cell in enumerate(nb_cells):
        cell["id"] = f"cell-{i}"
    return {
        "cells": nb_cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def main(device="cuda", out=HERE):
    """Execute each tutorial's cells on ``device`` and write its notebook
    under ``out``; returns the paths written."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_notebooks: no CUDA device; pass --device "
                           "cpu to execute the notebooks on the CPU")
    written = []
    os.makedirs(out, exist_ok=True)
    for script in SCRIPTS:
        doc, cells = split_script(os.path.join(HERE, script), device)
        nb = to_notebook(f"# {doc}\n\n{executed_on(device)}",
                         execute_cells(cells, HERE))
        path = os.path.join(out, script[:-3] + ".ipynb")
        with open(path, "w") as f:
            json.dump(nb, f, indent=1, ensure_ascii=False)
            f.write("\n")
        written.append(path)
        print("wrote", path)
    return written


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) or "cpu"')
    ap.add_argument("--out", default=HERE,
                    help="the directory to write the notebooks into")
    args = ap.parse_args()
    main(device=args.device, out=args.out)
