"""The workloads the tests and the card tests build: the primary junction
(``primary``), the harmonic, many-body and biased flagship junction
(``flagship``), the periodic graphene sheet (``sheet``) and the silicon
and gold slabs (``slab``); ``bias_stability`` is a CPU analysis of the
biased flagship. Where a runner call's time goes is traced inside the
program (``utils.profiling``) and read by ``python3 -m benchmarks.run
--trace 1``."""


def chunk_sizes(system, ntraj: int, nsteps: int, block=None) -> list:
    """The trajectory counts of the chunks ``RunEnsemble(ntraj, nsteps,
    block=block)`` runs (``block`` None: the plain step)."""
    from sclmd_tpu_torch.parallel.ensemble import auto_chunk

    chunk = min(auto_chunk(system, ntraj, nsteps, block, depth=2), ntraj)
    return [min(chunk, ntraj - c0) for c0 in range(0, ntraj, chunk)]
