"""Workload set-up and measurement scripts for the card: the primary
junction (``primary``), the harmonic flagship junction (``flagship``),
the K1 tile sweep (``k1_sweep``) and the plain step's timings
(``plain_bench``). Where a runner call's time goes is traced inside the
program (``utils.profiling``) and read by ``python3 -m benchmarks.run
--trace 1``."""
