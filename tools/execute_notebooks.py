"""Execute the example notebooks in place and commit their rendered
outputs (the reference ships `examples/a_getting_started.ipynb` with
executed cells; ours must too).

`a_getting_started` runs on JAX's default platform; `b_schemes_math`
pins itself to CPU/f64 in its first cell.  Usage:

    python tools/execute_notebooks.py [notebook.ipynb ...]

Defaults to both example notebooks.  Idempotent: re-running refreshes
outputs.
"""
import os
import sys
import time

import nbformat
from nbclient import NotebookClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = [os.path.join(REPO, "examples", n)
           for n in ("a_getting_started.ipynb", "b_schemes_math.ipynb")]


def execute(path):
    t0 = time.time()
    nb = nbformat.read(path, as_version=4)
    client = NotebookClient(
        nb, timeout=1200, kernel_name="python3",
        resources={"metadata": {"path": os.path.dirname(path)}})
    client.execute()
    nbformat.write(nb, path)
    n_out = sum(1 for c in nb.cells if c.get("outputs"))
    print(f"{os.path.basename(path)}: {len(nb.cells)} cells, "
          f"{n_out} with outputs ({time.time() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    for p in (sys.argv[1:] or DEFAULT):
        execute(p)
