"""Moving-MNIST synthesized on the device
(``graphical_gan_tpu/data/ondevice_moving_mnist.py``): SSGAN's ``device``
data path.

The 28x28 digit pool lives on the card, and each training iteration draws
digit indices, rolls the trajectory law and pastes the frames there:
fresh videos every iteration and no host bytes in the loop. The law is the
reference's (``tflib/simple_moving_mnist.py:9-48``), in f32 as the JAX
module computes it: uniform start in [0, 1]^2, uniform angle, constant
speed 0.1 per step, clamp-and-reflect at the walls, positions recorded
after the first step. The paste is a shifted gather with the rows and
columns outside the digit masked (no scatter, ``:69-95``).

The draws come from the trainer's ``torch.Generator``, in the JAX order
(the digit indices, then the start y, x and the angle's uniform); a caller
may pass them in by name (``idx``, ``y``, ``x``, ``theta``), as the parity
tests do.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

IMAGE_SIZE = 64
DIGIT_SIZE = 28
STEP_LENGTH = 0.1


def random_trajectory(generator: Optional[torch.Generator], n: int,
                      seq_length: int, device,
                      draws: Optional[Dict[str, torch.Tensor]] = None,
                      image_size: int = IMAGE_SIZE,
                      digit_size: int = DIGIT_SIZE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top, left) int32 [L, n] on ``device``."""
    draws = draws or {}

    def uniform(name):
        t = draws.get(name)
        if t is None:
            return torch.rand((n,), generator=generator, device=device)
        return t.to(device=device, dtype=torch.float32)

    canvas = image_size - digit_size
    y, x = uniform("y"), uniform("x")
    theta = uniform("theta") * (2 * math.pi)
    v_y, v_x = torch.sin(theta), torch.cos(theta)
    ys, xs = [], []
    for _ in range(seq_length):
        y = y + v_y * STEP_LENGTH
        x = x + v_x * STEP_LENGTH
        over, under = x >= 1.0, x <= 0.0
        x = torch.where(under, 0.0, torch.where(over, 1.0, x))
        v_x = torch.where(under | over, -v_x, v_x)
        over, under = y >= 1.0, y <= 0.0
        y = torch.where(under, 0.0, torch.where(over, 1.0, y))
        v_y = torch.where(under | over, -v_y, v_y)
        ys.append(y)
        xs.append(x)
    return ((canvas * torch.stack(ys)).to(torch.int32),
            (canvas * torch.stack(xs)).to(torch.int32))


def paste_digits(digits: torch.Tensor, top: torch.Tensor,
                 left: torch.Tensor) -> torch.Tensor:
    """digits [B, 28, 28]; top/left int32 [L, B] -> [B, L, 64*64]: each
    canvas pixel gathers the digit pixel at its offset, zero outside."""
    b = digits.shape[0]
    r = torch.arange(IMAGE_SIZE, device=digits.device)
    idx_r = r[None, None, :] - top.T.long()[:, :, None]       # [B, L, 64]
    idx_c = r[None, None, :] - left.T.long()[:, :, None]
    ok = (((idx_r >= 0) & (idx_r < DIGIT_SIZE))[:, :, :, None]
          & ((idx_c >= 0) & (idx_c < DIGIT_SIZE))[:, :, None, :])
    rows = idx_r.clamp(0, DIGIT_SIZE - 1)[:, :, :, None]
    cols = idx_c.clamp(0, DIGIT_SIZE - 1)[:, :, None, :]
    bi = torch.arange(b, device=digits.device)[:, None, None, None]
    frames = digits[bi, rows, cols] * ok                      # [B, L, 64, 64]
    return frames.reshape(b, top.shape[0], IMAGE_SIZE * IMAGE_SIZE)


def synthesize_videos(digits: torch.Tensor,
                      generator: Optional[torch.Generator], seq_length: int,
                      draws: Optional[Dict[str, torch.Tensor]] = None
                      ) -> torch.Tensor:
    """digits [B, 28, 28] float in [0, 1] -> videos [B, L, 4096] f32."""
    top, left = random_trajectory(generator, digits.shape[0], seq_length,
                                  digits.device, draws)
    return paste_digits(digits.float(), top, left)


def make_video_sampler(seq_length: int):
    """The ``Trainer(batch_sampler=...)`` hook: n fresh video batches per
    iteration from the resident digit pool ``{'digits': [N, 28, 28],
    'labels': [N, C] one-hot}``; returns ``{'x': [n, B, L, 4096], 'y':
    [n, B, C]}``, the host loader's batch form (``runs/ssgan.py``)."""
    def sampler(data, generator, n, batch_size, draws=None):
        pool = data["digits"]
        idx = None if draws is None else draws.get("idx")
        if idx is None:
            idx = torch.randint(0, pool.shape[0], (n * batch_size,),
                                generator=generator, device=pool.device)
        idx = idx.reshape(-1).to(device=pool.device, dtype=torch.long)
        videos = synthesize_videos(pool.index_select(0, idx), generator,
                                   seq_length, draws)
        return {"x": videos.reshape(n, batch_size, seq_length,
                                    IMAGE_SIZE * IMAGE_SIZE),
                "y": data["labels"].index_select(0, idx).reshape(
                    n, batch_size, -1)}

    return sampler
