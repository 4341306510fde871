"""Workload set-up and measurement scripts for the card: the primary
junction (``primary``), the K1 tile sweep (``k1_sweep``) and the
end-to-end profile of ``RunEnsemble`` (``profile_e2e``)."""
