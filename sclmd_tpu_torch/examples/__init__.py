"""The JAX package's ``examples/`` rebuilt on this package: the same
workloads and output files, on the CUDA card unless ``--device cpu``.

Run one from a scratch directory (outputs land in the current working
directory, as the reference's scripts do)::

    python -m sclmd_tpu_torch.examples.runmd --quick --device cpu
    python -m sclmd_tpu_torch.examples.current_induced.rundp --quick

Each module's ``main(argv)`` parses the same options and returns its key
results.
"""

import argparse


def parse_args(argv, doc, *, data=False, ensemble=False):
    """The examples' common options: ``--quick`` (a shorter run),
    ``--device`` (default: the CUDA card); ``--data PATH`` (a LAMMPS data
    file) and ``--ensemble N`` where an example takes them."""
    p = argparse.ArgumentParser(description=(doc or "").splitlines()[0])
    p.add_argument("--quick", action="store_true",
                   help="the shorter configuration")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    if data:
        p.add_argument("--data", default=None,
                       help="a LAMMPS data file to load instead of the "
                            "built-in junction")
    if ensemble:
        p.add_argument("--ensemble", type=int, default=None,
                       help="run N trajectories with RunEnsemble")
    return p.parse_args(argv)
