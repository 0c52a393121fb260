"""The toy family's plain reference: the denoiser and its sampler as plain
tensor arithmetic on a state dict, float32."""
import torch


def denoise(state, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    tt = t[:, None, None].expand(x.shape[0], x.shape[1], 1)
    h = torch.cat([x, tt], -1) @ state["fc1.weight"].T + state["fc1.bias"]
    return torch.relu(h) @ state["fc2.weight"].T + state["fc2.bias"]


def sample(state, x: torch.Tensor, steps: int) -> torch.Tensor:
    """The sampler's walk from the starting noise x."""
    for k in range(steps, 0, -1):
        t = torch.full((x.shape[0],), k / steps, device=x.device)
        x = x - denoise(state, x, t) / steps
    return x
