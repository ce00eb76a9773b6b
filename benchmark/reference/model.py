"""RiboDetector's read classifier, written plainly from its published model.

Source: hzi-bifo/RiboDetector v0.3.1, ``ribodetector/model/model.py``
``SeqModel``: ``nn.LSTM(4, 128, num_layers=1, bidirectional=True)`` over
one-hot reads and ``nn.Linear(256, 2)`` on the output at the read's last
base, in the CPU/ONNX ("dense") form: both directions run over every row of
the read padded to ``-l``, and the output is taken at the last row that is
not padding (row T-1 for a read with no called base). The weights are read
from the npz file the program ships, in its layout: ``w_ih`` [4, 512] and
``w_hh`` [128, 512] (nn.LSTM's weight_ih_l0 and weight_hh_l0 transposed),
``b`` [512] (bias_ih + bias_hh), gates in nn.LSTM's order i, f, g, o;
``w_out`` [256, 2] and ``b_out`` [2].

Everything is float32 with TF32 off, and nothing is bucketed, fused or
packed. ``precision="tf32"`` is the control: every matrix product's
operands rounded to TF32's 10-bit mantissa (forward and backward), the
accumulation in float32, as the card's TF32 tensor cores compute it. It is
emulated by rounding, so it reads the same on the CPU and the card.
"""

import numpy as np
import torch

HIDDEN = 128
FIELDS = ("w_ih_f", "w_hh_f", "b_f", "w_ih_b", "w_hh_b", "b_b", "w_out", "b_out")
PAD = 4  # the token of anything but an upper-case A, C, G, T or U

# byte -> token. FASTQ sequences are taken as written (a lower-case base
# reads as no call); FASTA sequences are upper-cased first (RiboDetector's
# fastx parser, and the port's: quirk #1 in the JAX package's SURVEY.md).
FASTQ_LUT = np.full(256, PAD, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    FASTQ_LUT[_b] = _i
FASTQ_LUT[ord("U")] = 3
FASTA_LUT = FASTQ_LUT.copy()
for _i, _b in enumerate(b"acgt"):
    FASTA_LUT[_b] = _i
FASTA_LUT[ord("u")] = 3


def strict_fp32():
    """No TF32 in float32 products (the reference's stated precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def load_weights(path, device="cpu"):
    """{field: float32 tensor on device} from the npz file."""
    with np.load(path) as z:
        return {k: torch.from_numpy(np.array(z[k], np.float32)).to(device) for k in FIELDS}


def encode(bases, lengths, max_len, fasta):
    """[n, W] uint8 read bytes (row i valid up to lengths[i]) -> [n, max_len]
    uint8 tokens: the first max_len bases, the rest padding."""
    lut = FASTA_LUT if fasta else FASTQ_LUT
    n, width = bases.shape
    tokens = np.full((n, max_len), PAD, np.uint8)
    w = min(width, max_len)
    tokens[:, :w] = lut[bases[:, :w]]
    tokens[np.arange(max_len)[None, :] >= np.asarray(lengths)[:, None]] = PAD
    return tokens


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32(a) @ _tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return _tf32(g) @ _tf32(b).T, _tf32(a).T @ _tf32(g)


def _product(a, b, precision):
    if precision == "fp32":
        return a @ b
    if precision == "tf32":
        return _Tf32Product.apply(a, b)
    raise ValueError(f"unknown precision {precision!r}")


def last_base(tokens):
    """[B, T] tokens -> the row the output is taken at: the last non-pad
    row, or T-1 when there is none."""
    T = tokens.shape[1]
    rows = torch.arange(T, device=tokens.device)
    last = torch.where(tokens != PAD, rows, -1).amax(dim=1)
    return torch.where(last < 0, T - 1, last)


def forward(w, tokens, precision="fp32"):
    """[B, T] integer tokens on w's device -> [B, 2] logits (differentiable
    in w)."""
    B, T = tokens.shape
    dev = tokens.device
    cols = tokens.long().T.contiguous()  # [T, B]: one contiguous row a step
    at = last_base(tokens)
    onehot = torch.cat([torch.eye(4, device=dev), torch.zeros(1, 4, device=dev)])
    outs = []
    for d, steps in ((0, range(T)), (1, range(T - 1, -1, -1))):
        s = "fb"[d]
        # row k: the input product of one-hot base k with the bias; the pad
        # row (a zero input) is the bias alone
        table = _product(onehot, w[f"w_ih_{s}"], precision) + w[f"b_{s}"]
        h = torch.zeros(B, HIDDEN, device=dev)
        c = h
        out = h
        for t in steps:
            gates = table[cols[t]] + _product(h, w[f"w_hh_{s}"], precision)
            i, f, g, o = gates.split(HIDDEN, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out = torch.where((at == t)[:, None], h, out)
        outs.append(out)
    return _product(torch.cat(outs, dim=1), w["w_out"], precision) + w["b_out"]


def logits(w, tokens, precision="fp32", block=131072):
    """[n, T] uint8 tokens (numpy) -> [n, 2] float32 logits (numpy), in
    blocks of rows on w's device."""
    strict_fp32()
    dev = w["w_out"].device
    parts = []
    with torch.no_grad():
        for a in range(0, len(tokens), block):
            tok = torch.from_numpy(np.ascontiguousarray(tokens[a: a + block])).to(dev)
            parts.append(forward(w, tok, precision).cpu().numpy())
    return np.concatenate(parts) if parts else np.zeros((0, 2), np.float32)


def labels(logit):
    """Single-end label: the argmax (0 = not rRNA, 1 = rRNA)."""
    return np.argmax(logit, axis=1).astype(np.int64)


def pair_labels(l1, l2, ensure):
    """RiboDetector's ensure rules for a pair (detect.py:600-663): rrna ->
    1 iff both ends say 1; norrna -> 0 iff both say 0; both -> the ends'
    common label, or -1 (unclassified) where they differ; none -> the argmax
    of the summed logits."""
    if ensure == "none":
        return np.argmax(l1 + l2, axis=1).astype(np.int64)
    a1, a2 = np.argmax(l1, axis=1), np.argmax(l2, axis=1)
    if ensure == "rrna":
        return ((a1 == 1) & (a2 == 1)).astype(np.int64)
    if ensure == "norrna":
        return ((a1 == 1) | (a2 == 1)).astype(np.int64)
    if ensure == "both":
        return np.where(a1 == a2, a1, -1).astype(np.int64)
    raise ValueError(f"unknown ensure mode {ensure!r}")


def margin(logit):
    """How far a read's label is from flipping: |logit_1 - logit_0|."""
    return np.abs(logit[:, 1] - logit[:, 0])


def pair_margin(l1, l2, ensure):
    """How far a pair's label is from flipping: the summed logits' margin
    under ensure none, else the smaller of the two ends'."""
    if ensure == "none":
        return margin(l1 + l2)
    return np.minimum(margin(l1), margin(l2))


def cross_entropy(logit, label):
    """Mean softmax cross entropy."""
    logp = torch.log_softmax(logit, dim=1)
    return -logp.gather(1, label.long()[:, None]).mean()


class Adam:
    """optax.adam (scale_by_adam, then the learning rate), leaf by leaf:

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  k += 1
        p -= lr * (mu / (1 - b1^k)) / (sqrt(nu / (1 - b2^k)) + eps)
    """

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu, self.nu, self.k = {}, {}, 0

    def step(self, w, grads):
        self.k += 1
        new = {}
        for name, g in grads.items():
            mu = (1 - self.b1) * g + self.b1 * self.mu.get(name, torch.zeros_like(g))
            nu = (1 - self.b2) * (g * g) + self.b2 * self.nu.get(name, torch.zeros_like(g))
            self.mu[name], self.nu[name] = mu, nu
            mu_hat = mu / (1 - self.b1 ** self.k)
            nu_hat = nu / (1 - self.b2 ** self.k)
            new[name] = w[name] - self.lr * mu_hat / (torch.sqrt(nu_hat) + self.eps)
        return new


def train_steps(w, batches, lr, precision="fp32"):
    """Adam steps of the mean cross entropy from weights w over batches
    [(tokens [B, T], labels [B]) on w's device] -> (the loss of each step,
    each leaf's gradient at the first step, the weights after the last)."""
    strict_fp32()
    opt = Adam(lr)
    losses, first = [], None
    for tokens, label in batches:
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
        loss = cross_entropy(forward(leaves, tokens, precision), label)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        if first is None:
            first = grads
        losses.append(float(loss.detach()))
        w = opt.step({k: v.detach() for k, v in leaves.items()}, grads)
    return losses, first, w


def evaluate(w, tokens, label, precision="fp32", block=4096):
    """(mean cross entropy, accuracy) over a labelled set (numpy)."""
    logit = torch.from_numpy(logits(w, tokens, precision, block))
    y = torch.from_numpy(np.asarray(label, np.int64))
    loss = float(torch.nn.functional.cross_entropy(logit, y, reduction="sum")) / len(y)
    return loss, float((logit.argmax(1) == y).double().mean())
