"""The reference's removal training step: the RemFX reference's ``RemFX``
task (remfx/models.py:152-256) under its trainer (cfg/config.yaml:110-120).

    loss = MR-STFT(output, target) + 100 * L1(output, target)

MR-STFT is auraloss's ``MultiResolutionSTFTLoss`` as the reference builds
it: FFT sizes 1024 / 2048 / 512, hops 120 / 240 / 50, Hann windows of 600 /
1200 / 240 samples centred in the FFT, spectral convergence (per item,
then the mean) plus the mean absolute log-magnitude difference, magnitudes
floored at sqrt(1e-8), the mean over resolutions. Then the gradient's
global norm is clipped at ``clip`` (scaled by ``clip / norm`` where the
norm reaches it), and AdamW (decoupled weight decay, bias-corrected
moments) updates every parameter.
"""

from __future__ import annotations

import torch

FFT_SIZES = (1024, 2048, 512)
HOP_SIZES = (120, 240, 50)
WIN_LENGTHS = (600, 1200, 240)
L1_WEIGHT = 100.0


def _mag(x, n_fft, hop, win):
    window = torch.hann_window(win, dtype=x.dtype, device=x.device)
    z = torch.stft(x.reshape(-1, x.shape[-1]), n_fft, hop, win_length=win, window=window,
                   center=True, pad_mode="reflect", return_complex=True)
    return torch.sqrt(torch.clamp(z.real ** 2 + z.imag ** 2, min=1e-8))


def removal_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    total = 0.0
    for n_fft, hop, win in zip(FFT_SIZES, HOP_SIZES, WIN_LENGTHS):
        mx, my = _mag(output, n_fft, hop, win), _mag(target, n_fft, hop, win)
        sc = (torch.linalg.norm(my - mx, dim=(-2, -1)) / torch.linalg.norm(my, dim=(-2, -1))).mean()
        lm = (torch.log(mx) - torch.log(my)).abs().mean()
        total = total + sc + lm
    return total / len(FFT_SIZES) + L1_WEIGHT * (output - target).abs().mean()


class AdamW:
    """torch's AdamW arithmetic over a list of tensors, written out."""

    def __init__(self, params, lr, betas, eps, weight_decay):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))


def clip_by_global_norm(grads, clip: float):
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if norm >= clip:
        grads = [g * (clip / norm) for g in grads]
    return grads


def train_steps(model, batches, optimizer: AdamW, clip: float, rows: int):
    """Steps of ``model`` over ``batches`` [(x, y)], each batch's loss and
    gradient summed over blocks of ``rows`` rows (the loss is a mean over
    rows, so a block weighs its share of them). -> (the losses, each leaf's
    clipped gradient norm of the first step)."""
    losses, first = [], None
    params = optimizer.params
    for x, y in batches:
        total, grads = 0.0, None
        for i in range(0, x.shape[0], rows):
            xb, yb = x[i:i + rows], y[i:i + rows]
            loss = removal_loss(model(xb), yb) * (xb.shape[0] / x.shape[0])
            g = torch.autograd.grad(loss, params)
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            total += loss.item()
        grads = clip_by_global_norm(grads, clip)
        if first is None:
            first = [torch.linalg.vector_norm(g).item() for g in grads]
        optimizer.step(grads)
        losses.append(total)
    return losses, first
