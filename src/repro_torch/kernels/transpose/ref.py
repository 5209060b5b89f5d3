"""Oracle for the tile-transpose kernel."""
import torch


def ref_transpose(x: torch.Tensor) -> torch.Tensor:
    """Swap the last two axes."""
    return x.transpose(-2, -1)
