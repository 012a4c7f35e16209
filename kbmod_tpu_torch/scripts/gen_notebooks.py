"""Generate the port's notebooks from its tested percent-format examples.

    python -m kbmod_tpu_torch.scripts.gen_notebooks [out_dir]

The port of the JAX package's scripts/gen_notebooks.py. The source of each
walkthrough is a runnable script, ``kbmod_tpu_torch/examples/*.py``
(jupytext percent format: ``# %%`` code cells, ``# %% [markdown]`` cells),
run on the CPU by tests/test_torch_examples_*.py and on the card by
chip_smoke.py; the ``.ipynb`` rendering is derived from it, nbformat 4 with
no outputs, into ``kbmod_tpu_torch/examples/notebooks/`` by default, so the
notebooks cannot drift from code that runs. tests/test_torch_generated_docs.py
regenerates into a temporary directory and fails if the committed tree is
stale.
"""

import argparse
import json
import os
import re

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
NOTEBOOKS = os.path.join(EXAMPLES, "notebooks")

CELL_RE = re.compile(r"^# %%(?: \[(?P<kind>\w+)\])?\s*$")


def parse_percent_cells(text):
    """Split percent-format source into (kind, source_lines) cells."""
    cells = []
    kind, lines = None, []
    for line in text.splitlines():
        m = CELL_RE.match(line)
        if m:
            if kind is not None or lines:
                cells.append((kind or "code", lines))
            kind, lines = m.group("kind") or "code", []
        else:
            lines.append(line)
    if kind is not None or lines:
        cells.append((kind or "code", lines))
    return cells


def to_notebook(py_path):
    cells = []
    with open(py_path) as f:
        text = f.read()
    for kind, lines in parse_percent_cells(text):
        # Trim the blank padding between cells.
        while lines and not lines[0].strip():
            lines.pop(0)
        while lines and not lines[-1].strip():
            lines.pop()
        if not lines:
            continue
        if kind == "markdown":
            src = [re.sub(r"^# ?", "", ln) for ln in lines]
            cells.append({"cell_type": "markdown", "metadata": {}, "source": _nl(src)})
        else:
            cells.append({
                "cell_type": "code", "metadata": {}, "source": _nl(lines),
                "execution_count": None, "outputs": [],
            })
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python", "name": "python3"},
            "language_info": {"name": "python"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def _nl(lines):
    """Notebook source: every line but the last ends with a newline."""
    return [ln + "\n" for ln in lines[:-1]] + [lines[-1]]


def generate(out_dir):
    """Write one notebook per example into ``out_dir``; return their names."""
    os.makedirs(out_dir, exist_ok=True)
    names = sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py"))
    for name in names:
        nb = to_notebook(os.path.join(EXAMPLES, name))
        with open(os.path.join(out_dir, name[:-3] + ".ipynb"), "w") as f:
            json.dump(nb, f, indent=1, sort_keys=True)
            f.write("\n")
    return [name[:-3] + ".ipynb" for name in names]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default=NOTEBOOKS, help="where the notebooks go")
    args = ap.parse_args(argv)
    names = generate(args.out_dir)
    print(f"wrote {len(names)} notebooks to {args.out_dir}")


if __name__ == "__main__":
    main()
