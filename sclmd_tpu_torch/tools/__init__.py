"""Workload set-up and measurement scripts for the card: the primary
junction (``primary``), the harmonic flagship junction (``flagship``),
the K1 tile sweep (``k1_sweep``), the end-to-end profiles
(``profile_e2e``) and the plain step's timings (``plain_bench``)."""
