"""The toy family's system under test: a two-layer MLP that predicts the
noise of every point of a cloud from its coordinates and the time, and a
deterministic sampler that walks a cloud of Gaussian noise down its
predictions."""
import torch
from torch import nn


class Denoiser(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(4, hidden)
        self.fc2 = nn.Linear(hidden, 3)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x (B, N, 3), t (B,) -> the predicted noise (B, N, 3)."""
        tt = t.to(x.dtype)[:, None, None].expand(x.shape[0], x.shape[1], 1)
        return self.fc2(torch.relu(self.fc1(torch.cat([x, tt], -1))))


@torch.no_grad()
def sample(model: Denoiser, batch: int, points: int, steps: int,
           generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """`steps` updates x <- x - eps(x, k / steps) / steps, k = steps .. 1,
    from noise drawn with `generator`; the model runs in `dtype`."""
    x = torch.randn(batch, points, 3, generator=generator,
                    device=generator.device)
    for k in range(steps, 0, -1):
        t = torch.full((batch,), k / steps, device=x.device)
        x = x - model(x.to(dtype), t).float() / steps
    return x
