"""PyTorch/CUDA port of sclmd_tpu: semi-classical GLE molecular dynamics
on an NVIDIA H100.

Module paths and public names mirror ``sclmd_tpu`` (``baths.phbath``,
``md.md``, ``md.run_segment_blocked``, ``parallel.ensemble.auto_chunk``,
...). Host-side setup (PSD build, eigh, memory kernels, ``set_dyn``) is
numpy float64 as in the JAX package; the hot loop runs on torch tensors
with an explicit leading trajectory dimension, through the hand-written
kernels of ``sclmd_tpu_torch.kernels`` on CUDA tensors and their plain
torch twins on CPU tensors.
"""

import torch


def pin_precision():
    """Full-fp32 matmuls and convolutions: no TF32 anywhere.

    TF32 keeps ~3 decimal digits; the JAX package measured what a
    reduced-precision conservative force does to a long GLE run (bf16
    passes heated the 201-atom junction from etot 1e1 to 8e16 over 4096
    steps), so every float32 product runs at full precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def precision_pinned() -> bool:
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: ``device`` as given, else the first
    CUDA card. Without a card a default raises instead of falling back to
    the CPU; a CPU run asks for it with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "sclmd_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", 0)


pin_precision()
