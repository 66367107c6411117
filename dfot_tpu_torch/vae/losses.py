"""VAE training losses: LPIPS, the PatchGAN discriminator, the adversarial,
reconstruction and KL terms and the adaptive generator weight.

Port of ``dfot_tpu/vae/losses.py``, channel-first (NCHW):

- :class:`VGG16Features` and :class:`LPIPS`: VGG16's five relu stages and
  the learned 1x1 heads over unit-normalized feature differences; the
  weights of torchvision's ``vgg16`` and of the ``lpips`` package's
  ``vgg.pth`` load through :func:`lpips_state_dict`.
- :class:`NLayerDiscriminator`: the PatchGAN as the JAX package builds it:
  flax's ``SAME`` padding (a 4x4 stride-1 conv pads one row before and two
  after) and flax's BatchNorm (:class:`BatchNorm`), whose running variance
  averages the biased batch variance, where torch's ``BatchNorm2d`` keeps
  the unbiased one. A forward in training mode normalizes by the batch's
  statistics and, with ``update_stats``, folds them into the running ones.
- the losses (:func:`hinge_d_loss`, :func:`vanilla_d_loss`,
  :func:`adopt_weight`, :func:`vae_generator_loss`,
  :func:`calculate_adaptive_weight`, :func:`vae_discriminator_loss`) and
  :func:`decoder_last_layer`, the decoder's final conv weight that the
  adaptive weight differentiates against (a module attribute here, where the
  JAX package walks a parameter tree).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "VGG16Features", "LPIPS", "BatchNorm", "NLayerDiscriminator", "hinge_d_loss",
    "vanilla_d_loss", "adopt_weight", "vae_generator_loss", "calculate_adaptive_weight",
    "vae_discriminator_loss", "decoder_last_layer", "lpips_state_dict",
]

_VGG_SLICES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
# torchvision vgg16 ``features.{idx}`` conv index per (stage, conv in stage)
_VGG_TORCHVISION_IDX = (
    (0, 0, 0), (0, 1, 2), (1, 0, 5), (1, 1, 7), (2, 0, 10), (2, 1, 12), (2, 2, 14),
    (3, 0, 17), (3, 1, 19), (3, 2, 21), (4, 0, 24), (4, 1, 26), (4, 2, 28),
)


class VGG16Features(nn.Module):
    """VGG16's five relu stages over (B, 3, H, W) in [-1, 1], after LPIPS's
    scaling layer."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (n_convs, ch) in enumerate(_VGG_SLICES):
            for j in range(n_convs):
                self.add_module(f"conv{i}_{j}", nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor):
        h = (x - self.shift) / self.scale
        feats = []
        for i, (n_convs, _) in enumerate(_VGG_SLICES):
            for j in range(n_convs):
                h = F.relu(getattr(self, f"conv{i}_{j}")(h))
            feats.append(h)
            if i != len(_VGG_SLICES) - 1:
                h = F.max_pool2d(h, 2, 2)
        return feats


class LPIPS(nn.Module):
    """Learned perceptual distance between two (B, 3, H, W) batches -> (B,)."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (_, ch) in enumerate(_VGG_SLICES):
            self.add_module(f"lin{i}", nn.Conv2d(ch, 1, 1, bias=False))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for i, (a, b) in enumerate(zip(self.vgg(x), self.vgg(y))):
            a = a / a.norm(dim=1, keepdim=True).clamp_min(1e-10)
            b = b / b.norm(dim=1, keepdim=True).clamp_min(1e-10)
            total = total + getattr(self, f"lin{i}")((a - b) ** 2).mean(dim=(1, 2, 3))
        return total


def lpips_state_dict(lin_state: Mapping, vgg_state: Mapping) -> Dict[str, torch.Tensor]:
    """:class:`LPIPS`'s state dict from the ``lpips`` package's ``vgg.pth``
    (``lin{i}.model.1.weight``) and torchvision's ``vgg16`` state dict
    (``features.{idx}.weight`` / ``.bias``): the names
    ``dfot_tpu/vae/losses.py:import_lpips_params`` reads."""
    out = {}
    for stage, j, idx in _VGG_TORCHVISION_IDX:
        for leaf in ("weight", "bias"):
            out[f"vgg.conv{stage}_{j}.{leaf}"] = torch.as_tensor(
                vgg_state[f"features.{idx}.{leaf}"], dtype=torch.float32)
    for i in range(len(_VGG_SLICES)):
        out[f"lin{i}.weight"] = torch.as_tensor(lin_state[f"lin{i}.model.1.weight"],
                                                dtype=torch.float32)
    return out


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the channels of (B, C, H, W): batch
    statistics as mean(x^2) - mean(x)^2 (fp32 or wider, clipped at 0), running
    statistics ``momentum * running + (1 - momentum) * batch`` with the
    biased batch variance."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        if train:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_((1 - m) * mean)
                    self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        view = (1, -1, 1, 1)
        y = (x - mean.view(view)) * (torch.rsqrt(var + self.eps) * self.weight).view(view)
        return (y + self.bias.view(view)).to(x.dtype)


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """flax's ``SAME`` padding of a k x k conv with this stride: the output
    is ceil(in / stride), the odd pixel of the padding goes after."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator (pix2pix-style) over (B, 3, H, W): 4x4 convs,
    the first of stride 2 with a bias, then ``n_layers`` bias-free convs with
    BatchNorm (stride 2 but the last), leaky relu 0.2, a 4x4 conv to one
    logit a patch."""

    def __init__(self, in_channels: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(in_channels, ndf, 4, stride=2)
        cin = ndf
        for n in range(1, n_layers + 1):
            nf = min(2 ** n, 8)
            self.add_module(f"conv{n}", nn.Conv2d(cin, ndf * nf, 4, stride=2 if n < n_layers else 1,
                                                  bias=False))
            self.add_module(f"bn{n}", BatchNorm(ndf * nf))
            cin = ndf * nf
        self.conv_out = nn.Conv2d(cin, 1, 4)

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        h = F.leaky_relu(self.conv0(_same_pad(x, 4, 2)), 0.2)
        for n in range(1, self.n_layers + 1):
            conv = getattr(self, f"conv{n}")
            h = conv(_same_pad(h, 4, conv.stride[0]))
            h = F.leaky_relu(getattr(self, f"bn{n}")(h, train, update_stats), 0.2)
        return self.conv_out(_same_pad(h, 4, 1))


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def adopt_weight(weight: float, global_step: int, threshold: int) -> float:
    """The adversarial weight, zero before ``threshold`` (``disc_start``)."""
    return weight if global_step >= threshold else 0.0


def vae_generator_loss(
    recon: torch.Tensor, target: torch.Tensor, kl: torch.Tensor,
    logits_fake: Optional[torch.Tensor], *, kl_weight: float, disc_weight: float,
    perceptual: Optional[torch.Tensor] = None, perceptual_weight: float = 1.0,
    loss_type: str = "l1", adaptive_weight: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The autoencoder's loss: reconstruction (+ perceptual), KL and the
    adaptive-weighted adversarial term; returns (total, parts)."""
    rec = (recon - target).abs() if loss_type == "l1" else (recon - target) ** 2
    rec_total = rec.mean()
    if perceptual is not None:
        rec_total = rec_total + perceptual_weight * perceptual.mean()
    kl_loss = kl.mean()
    g_loss = (-logits_fake.mean() if logits_fake is not None
              else torch.zeros((), device=recon.device))
    aw = adaptive_weight if adaptive_weight is not None else 1.0
    total = rec_total + kl_weight * kl_loss + disc_weight * aw * g_loss
    return total, {"rec_loss": rec_total, "kl_loss": kl_loss, "g_loss": g_loss}


def calculate_adaptive_weight(nll_grads: torch.Tensor, g_grads: torch.Tensor,
                              disc_weight: float = 1.0) -> torch.Tensor:
    """||grad(nll)|| / (||grad(gan)|| + 1e-4), both with respect to the
    decoder's last layer, clipped to [0, 1e4], detached, times
    ``disc_weight``."""
    d = nll_grads.norm() / (g_grads.norm() + 1e-4)
    return d.clamp(0.0, 1e4).detach() * disc_weight


def vae_discriminator_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor,
                           disc_weight: float, loss_type: str = "hinge") -> torch.Tensor:
    fn = hinge_d_loss if loss_type == "hinge" else vanilla_d_loss
    return disc_weight * fn(logits_real, logits_fake)


def decoder_last_layer(vae: nn.Module) -> nn.Parameter:
    """The weight of the decoder's final conv (``decoder.conv_out``; the
    inner conv of a VideoVAE's ``CausalConv3d``)."""
    conv = vae.decoder.conv_out
    return getattr(conv, "conv", conv).weight
