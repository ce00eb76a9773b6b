"""optax.adam and optax.adamw as device tensor ops over one flat gradient.

Counterpart of the optimizer of ``ribodetector_tpu/train/trainer.py``
(``make_optimizer``: optax.adam, or optax.adamw when the config's weight
decay is non-zero). Its state lives on the parameters' device: the two
moments as flat buffers, and the step count as an int32 tensor (optax's
``count``). So an update makes no host sync, and the train step captures
it in its CUDA graph after the backward pass (train/trainer.py).

The arithmetic is optax's, op for op in fp32 and in its order
(``scale_by_adam``, ``add_decayed_weights``, ``scale_by_learning_rate``,
``apply_updates``):

    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * (g * g) + b2 * nu
    count = count + 1
    u = (mu / (1 - b1 ** count)) / (sqrt(nu / (1 - b2 ** count)) + eps)
    u = u + weight_decay * p                  (adamw only)
    p = p + (-lr) * u

with the bias corrections computed on the device in fp32 from the int32
count, as optax computes them. The CPU runs the same ops as the card.
"""

import torch


def leaf_views(flat, leaves):
    """Each leaf's slice of a flat buffer, in the leaf's shape."""
    return [v.view_as(p) for p, v in zip(leaves, flat.split([p.numel() for p in leaves]))]


class Adam:
    """Adam (optax.adam) over `params`, or AdamW (optax.adamw) when
    weight_decay is non-zero, updating the parameters in place.

    update(grad) takes the flat gradient: every leaf's gradient flattened
    and concatenated in the order of `params`."""

    def __init__(self, params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        first = self.params[0]
        n = sum(p.numel() for p in self.params)
        self.mu = torch.zeros(n, dtype=first.dtype, device=first.device)
        self.nu = torch.zeros_like(self.mu)
        self.count = torch.zeros((), dtype=torch.int32, device=first.device)
        self.lr, self.weight_decay, self.b1, self.b2, self.eps = lr, weight_decay, b1, b2, eps

    @torch.no_grad()
    def update(self, grad):
        """One update from the flat gradient `grad`: no host sync, so a CUDA
        graph can capture it."""
        b1, b2 = self.b1, self.b2
        self.mu.mul_(b1).add_(grad * (1 - b1))
        self.nu.mul_(b2).add_((grad * grad) * (1 - b2))
        self.count.add_(1)
        mu_hat = self.mu / (1 - torch.pow(b1, self.count))
        nu_hat = self.nu / (1 - torch.pow(b2, self.count))
        # the root in fp64, rounded once to fp32, is fp32's correctly rounded
        # root (53 >= 2 * 24 + 2 bits), as optax's is; torch's vectorized
        # fp32 sqrt on the CPU is one ulp off for ~0.7% of inputs
        u = mu_hat / (nu_hat.double().sqrt().float() + self.eps)
        if self.weight_decay:
            u.add_(torch.cat([p.reshape(-1) for p in self.params]) * self.weight_decay)
        u.mul_(-self.lr)
        torch._foreach_add_(self.params, leaf_views(u, self.params))

    def steps(self):
        """The updates made so far (reads the device count: a host sync)."""
        return int(self.count)
