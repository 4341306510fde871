"""K10, ``kernels.eam_force`` (``EAMForceCuda.__call__``): the Sutton-Chen
EAM force, two evaluations a step of the plain integrator. An evaluation
launches three kernels: the slot transpose (q to the displacements,
trajectory-minor), the centre pass and the gather. Per trajectory and
evaluation, the float32 operations this geometry needs, from the
reference model's own term lists (``counts``), each piece once: a table
entry's geometry 25 (difference, norm, minimum image), an entry inside
the cutoff 25 for its density term (the switch and the powers) and 25
for its pair term and gradient, an atom's embedding 20, and 7 for each
of the two atoms an entry's gradient is gathered onto; q read and the
force written once a trajectory, the table (an entry's record and head
entry, an atom's pointers, conv and f0) read once an evaluation."""

# the program counts an evaluation, which runs each of the three kernels
# once
COUNTERS = [("sclmd_tpu_torch.kernels.eam_force", "launches")] * 3
KERNELS = ("slot_transpose_kernel", "eam_centre_kernel",
           "slot_gather_kernel")
OPS = dict(entry=25, rho=25, grad=25, embed=20, gather=7)


def per_trajectory(c):
    return {"f32": OPS["entry"] * c["entries"]
            + (OPS["rho"] + OPS["grad"]) * c["inside"]
            + OPS["embed"] * c["atoms"] + OPS["gather"] * 2 * c["entries"],
            "bytes": 4 * 2 * 3 * c["atoms"]}


def table_bytes(c):
    return 4 * (6 * c["entries"] + 8 * c["atoms"])


def per_call(s):
    if s["block"] is not None or s["potential"]["kind"] != "eam":
        return None
    c = s["potential"]["counts"]
    w = per_trajectory(c)
    w = {"f32": w["f32"] * s["ntraj"],
         "bytes": w["bytes"] * s["ntraj"] + table_bytes(c)}
    return {k: v * 2 * s["nsteps"] for k, v in w.items()}
