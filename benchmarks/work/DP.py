"""DP, the DeepPot-SE network of ``models.nnp.deepmddriver``: its
forward pass and input-gradient backward by autograd, two evaluations a
step of the plain integrator. Per trajectory and evaluation, the float32
operations of its products (two a multiply-add), from the reference
model's layer widths and term counts (``counts`` under ``dp``), each
once: every layer of the embedding net on each table entry inside the
cutoff and of the fitting net on each atom, forward and back to its
input (the weights take no gradient), the first embedding layer a
one-wide product; G's sum over the entries, forward and to both its
factors; D's product, forward and to both its factors. q read and the
force written once a trajectory, the weights read once an evaluation."""

# the program counts an evaluation (``launches.DP``). An evaluation runs
# about 130 kernels of cuBLAS and ATen (a traced card run), most of them
# by names other code uses too; the ten that only the network runs and
# whose number its layers fix name it here: the tanh of each hidden
# layer (two embedding, three fitting) and its backward
COUNTERS = [("sclmd_tpu_torch.models.nnp", "launches")] * 10
KERNELS = ("tanh_kernel_cuda", "tanh_backward_kernel_cuda")


def layers(widths):
    return list(zip(widths[:-1], widths[1:]))


def per_trajectory(c):
    emb = sum(2 * a * b for a, b in layers(c["embed"]))
    fit = sum(2 * a * b for a, b in layers(c["fit"]))
    nemb = c["embed"][-1]
    g = 2 * nemb * 4
    d = 2 * nemb * c["axis"] * 4
    return {"f32": 2 * emb * c["inside"] + 3 * g * c["inside"]
            + (2 * fit + 3 * d) * c["atoms"],
            "bytes": 4 * 2 * 3 * c["atoms"]}


def weight_bytes(c):
    return 4 * sum(a * b + b for a, b in layers(c["embed"]) + layers(c["fit"]))


def per_call(s):
    dp = s["potential"].get("dp")
    if s["block"] is not None or dp is None:
        return None
    w = per_trajectory(dp)
    w = {"f32": w["f32"] * s["ntraj"],
         "bytes": w["bytes"] * s["ntraj"] + weight_bytes(dp)}
    return {k: v * 2 * s["nsteps"] for k, v in w.items()}
