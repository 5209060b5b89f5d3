"""Kernel families.  Each keeps the reference's split: ``ref.py`` (the
plain torch oracle), ``kernel.py`` (the wrappers around the hand-written
CUDA kernels in ``csrc/``, each beside its plain torch version) and
``ops.py`` (engine registration and the public op).  CUDA sources build
at the first launch on the card (``kernels/_build.py``), never at import.
"""
import torch


def disable_tf32() -> None:
    """Keep fp32 products in full fp32 on the card: the plain versions and
    the ``torch`` backend compare against kernels that never use TF32.
    bf16 products keep their fp32 accumulation to the end too (no reduced
    precision split-K reduction)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
