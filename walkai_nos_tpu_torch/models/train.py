"""Train and infer steps for the detector, on one device.

Port of `walkai_nos_tpu/models/train.py`. Training is the set-prediction
loss in the YOLOS spirit with a fixed token<->target assignment (one
target per detection token slot): cross-entropy on classes plus L1 on
the boxes of real targets, no-object class elsewhere.

There is no mesh here: the JAX steps shard over a 4-axis mesh, the port
runs on one device (tensor and data parallelism are a later slice). The
JAX step donates its state and returns a new one; the port's step
updates the state IN PLACE (the model's parameters, the optimizer's
moments and the step count) and returns it.

The optimizer matches `optax.adamw` as `make_optimizer` builds it:
AdamW (b1 0.9, b2 0.999, eps 1e-8) decaying EVERY parameter, biases and
norms included; optional global-norm clipping that scales by
max / norm only when norm >= max (no epsilon); the warmup-cosine and
warmup-hold schedules evaluated at optax's count (0 for the first
update).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from walkai_nos_tpu_torch.device import resolve_device
from walkai_nos_tpu_torch.models.data import to_device
from walkai_nos_tpu_torch.models.vit import ViTConfig, ViTDetector

__all__ = [
    "Optimizer",
    "TrainState",
    "detection_loss",
    "init_train_state",
    "make_infer_step",
    "make_optimizer",
    "make_train_step",
]


@dataclass
class TrainState:
    """The model (its parameters are the f32 masters), the optimizer
    that holds the AdamW moments, and the number of updates applied."""

    params: ViTDetector
    opt_state: torch.optim.Optimizer
    step: int = 0


def detection_loss(outputs, batch, *, num_classes: int) -> torch.Tensor:
    """CE over classes (+ no-object) and L1 over boxes of real targets.

    batch: images [b,h,w,3], labels [b,T] int (num_classes-1 = no-object),
    boxes [b,T,4]. T = num_det_tokens."""
    logits = outputs["logits"]
    labels = batch["labels"].long()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(), labels.reshape(-1))
    is_obj = (labels != num_classes - 1).float()
    l1 = ((outputs["boxes"] - batch["boxes"]).abs().sum(-1) * is_obj).sum()
    return ce + l1 / torch.clamp(is_obj.sum(), min=1.0)


@dataclass(frozen=True)
class Optimizer:
    """`make_optimizer`'s transformation: `init` builds the AdamW state
    for a model, `apply` clips, sets the scheduled rate and updates."""

    lr: float = 1e-4
    weight_decay: float = 1e-4
    clip_norm: float | None = None
    warmup_steps: int = 0
    decay_steps: int = 0

    def schedule(self, count: int) -> float:
        """The learning rate of update number `count` (0-based)."""
        lr, warm, decay = self.lr, self.warmup_steps, self.decay_steps
        if decay:
            if warm and count < warm:
                return lr * count / warm  # linear from 0 (init 0.0)
            t = min(count - warm, decay)
            return lr * 0.5 * (1 + math.cos(math.pi * t / decay))
        if warm:
            return lr * min(count, warm) / warm
        return lr

    def init(self, model: torch.nn.Module) -> torch.optim.Optimizer:
        return torch.optim.AdamW(
            model.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=self.weight_decay,
        )

    @torch.no_grad()
    def apply(self, opt: torch.optim.Optimizer, count: int) -> None:
        """One update from the parameters' `.grad` (update number
        `count`)."""
        params = [p for g in opt.param_groups for p in g["params"] if p.grad is not None]
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(p.grad.float()) for p in params])
            )
            scale = torch.where(
                norm < self.clip_norm, torch.ones_like(norm), self.clip_norm / norm
            )
            for p in params:
                p.grad.mul_(scale.to(p.grad.dtype))
        for group in opt.param_groups:
            group["lr"] = self.schedule(count)
        opt.step()


def make_optimizer(
    lr: float = 1e-4,
    *,
    weight_decay: float = 1e-4,
    clip_norm: float | None = None,
    warmup_steps: int = 0,
    decay_steps: int = 0,
) -> Optimizer:
    """AdamW, optionally with global-norm clipping and a linear-warmup
    cosine-decay schedule (`decay_steps` counts post-warmup steps;
    either knob alone works, both zero keeps the constant rate; warmup
    alone ramps to the peak, then holds)."""
    return Optimizer(lr, weight_decay, clip_norm, warmup_steps, decay_steps)


def init_train_state(
    cfg: ViTConfig, *, seed: int = 0, lr: float = 1e-4, device=None,
) -> TrainState:
    """A fresh model from `seed` on `device` (`cuda` unless the caller
    passes `device="cpu"`) and its optimizer state."""
    model = ViTDetector(cfg, device=device, seed=seed)
    return TrainState(model, make_optimizer(lr).init(model), 0)


def make_train_step(cfg: ViTConfig, *, lr: float = 1e-4, device=None):
    """Returns `(state, batch) -> (state, loss)`: one AdamW step of the
    detection loss (`make_optimizer(lr)`), applied to `state` in place.
    `batch` holds images, labels and boxes (tensors or numpy arrays);
    the loss is a 0-d tensor on the device, not synced to the host."""
    dev = resolve_device(device)
    tx = make_optimizer(lr)

    def step(state: TrainState, batch) -> tuple[TrainState, torch.Tensor]:
        model = state.params
        batch = to_device(batch, dev)
        state.opt_state.zero_grad(set_to_none=True)
        loss = detection_loss(model(batch["images"]), batch, num_classes=cfg.num_classes)
        loss.backward()
        tx.apply(state.opt_state, state.step)
        state.step += 1
        return state, loss.detach()

    return step


def make_infer_step(cfg: ViTConfig, *, device=None):
    """Returns `(model, images) -> outputs` under `torch.inference_mode`
    (images [b, image_size, image_size, 3] as a tensor or numpy array,
    moved to the device)."""
    dev = resolve_device(device)
    shape = (cfg.image_size, cfg.image_size, 3)

    def infer(model: ViTDetector, images) -> dict[str, torch.Tensor]:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.asarray(images))
        if images.dim() != 4 or tuple(images.shape[1:]) != shape:
            raise ValueError(f"images {tuple(images.shape)}: expected [b, *{shape}]")
        with torch.inference_mode():
            return model(images.to(dev))

    return infer
