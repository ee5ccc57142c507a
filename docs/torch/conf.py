"""Sphinx configuration of the PyTorch/CUDA port's reference pages.

Build (with Sphinx, its ``sphinx_rtd_theme`` and torch installed), from the
repository's root:

    sphinx-build -b html -W docs/torch docs/_build/torch
"""

import os
import sys

# autodoc imports the port from this checkout
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..", "..")))

project = "pytorch_nmf_tpu_torch"
author = "pytorch_nmf_tpu developers"
extensions = [
    "sphinx.ext.autodoc",
    "sphinx.ext.napoleon",
    "sphinx.ext.mathjax",
    "sphinx.ext.viewcode",
]
html_theme = "sphinx_rtd_theme"
