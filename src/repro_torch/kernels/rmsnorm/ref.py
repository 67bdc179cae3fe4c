"""Plain PyTorch RMSNorm: the oracle of ``csrc/rmsnorm.cu``."""
import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)
