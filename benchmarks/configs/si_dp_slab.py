"""si_dp_slab: the silicon slab of ``si_slab`` under a DeepPot-SE network
at DeePMD-kit's ``se_e2_a`` widths overlaid on its Stillinger-Weber
force: the network's forward pass and input-gradient backward by
autograd (cuBLAS products and ATen kernels, twice a step), K9 for the SW
term and K7's wide route for the baths, replayed as a CUDA graph.

``build`` makes ``si_slab``'s runner through the program's public API
and puts ``models.nnp.deepmddriver`` in its driver's place, with that
driver as its ``baseline``: a one-type ``DeepPotSE`` on its own table
(``build_neighbors``, auto-sized) whose weights are the harness's input
of the run's seed (``si_dp_slab_reference.weights``, handed over with
``set_params``). It records the seed in the configuration, so that the
reference reads the same weights.
"""

import numpy as np

from benchmarks.configs import si_slab


def build(cfg, device, dtype, seed, outdir):
    """The program's ``md`` runner of the slab, writing to ``outdir``."""
    from benchmarks.configs.si_dp_slab_reference import weights
    from sclmd_tpu_torch.models.nnp import (DeepPotSE, build_neighbors,
                                            deepmddriver)

    r = si_slab.build(cfg, device, dtype, seed, outdir)
    dp = cfg["deeppot"]
    dp["weights_seed"] = seed
    axyz, cell = si_slab.geometry(cfg)
    x0 = np.array([a[1:] for a in axyz], float)
    nbr, mask = build_neighbors(x0, dp["rcut"], None, cell=cell,
                                skin=dp["skin"])
    model = DeepPotSE(np.zeros(len(x0), int), len(dp["type_map"]),
                      dp["rcut"], dp["rcut_smth"], nbr, mask,
                      embed_sizes=dp["neuron"],
                      fit_sizes=dp["fitting_neuron"],
                      naxis=dp["axis_neuron"], cell=cell, dtype=dtype,
                      device=device)
    emb, fit = weights(cfg)
    model.set_params({"embed": [emb], "fit": [fit]})
    r.AddPotential(deepmddriver(model, axyz, dtype=dtype, device=device,
                                baseline=r.pforce))
    return r
