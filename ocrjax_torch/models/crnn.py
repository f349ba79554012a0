"""CRNN text-line recognizer (port of ocrjax/models/crnn.py).

Layers follow the flax modules' arithmetic, not PyTorch defaults:
  * SAME padding is XLA's: for stride 2 on even sizes it pads (0, 1), where
    a symmetric torch `padding=` would shift the grid by a pixel;
  * parameters stay float32 and are cast to the compute dtype in each
    layer (flax's param_dtype / dtype split); BatchNorm in eval mode
    evaluates (x - mean) * (rsqrt(var + eps) * scale) + bias in the
    compute dtype, in flax's order; in train mode it follows flax's
    nn.BatchNorm(momentum=0.9) (see BatchNorm);
  * the BiLSTM's reverse direction reads each sample's valid prefix only,
    like flax nn.RNN(reverse=True, keep_order=True, seq_lengths=...).
Under a mesh (parallel.mesh) two attributes switch layers to their sharded
compute: a BatchNorm's `sync` takes the train-mode statistics over the
whole data-parallel batch, and a layer's `tp` (ConvBNRelu's conv, BiLSTM,
the CRNN's projection) marks its parameters as column-parallel local
shards (parallel.mesh.TpGroup). Both are None on an unsharded model.
Modules are NCHW. The LSTM and the projection run in float32 (the
reference casts the LSTM's gate products to the compute dtype; the port
keeps cuDNN's float32 LSTM).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

WIDTH_STRIDE = 4
INPUT_HEIGHT = 32
BN_EPS = 1e-5


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size: Tuple[int, int], kernel: Tuple[int, int],
              stride: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """XLA SAME padding as an F.pad tuple (left, right, top, bottom):
    low = floor(total / 2), high = ceil(total / 2)."""
    pads = []
    for n, k, s in zip(size, kernel, stride):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    (t, b), (l, r) = pads
    return (l, r, t, b)


class Conv2d(nn.Module):
    """Conv with float32 parameters computed in `dtype`. padding: "SAME"
    (XLA convention) or explicit ((top, bottom), (left, right))."""

    tp = None

    def __init__(self, cin: int, cout: int, kernel=3, stride=1,
                 padding: Union[str, Tuple] = "SAME", bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        if self.padding == "SAME":
            pads = same_pads(x.shape[-2:], self.kernel, self.stride)
        else:
            (t, b), (l, r) = self.padding
            pads = (l, r, t, b)
        x = F.pad(x.to(self.dtype), pads)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), b, stride=self.stride)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW channels with flax's semantics.

    Eval mode normalizes by the running statistics in the input's dtype.
    Train mode (module.training, as the trainers set it) is flax 0.12's
    nn.BatchNorm(use_running_average=False, momentum=0.9), not
    torch.nn.BatchNorm2d's: the batch statistics are taken in float32 even
    under bf16, the variance is the biased fast form mean(x^2) - mean(x)^2
    clamped at 0, the normalization runs in float32 and is cast back, and
    the running update is 0.9 * old + (1 - 0.9) * batch with that biased
    variance (BatchNorm2d keeps the unbiased one). With a `sync` the two
    moments are summed over the data-parallel batch (autograd flows
    through the sums), as flax takes them over a sharded batch."""

    sync = None

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        dt = x.dtype
        shape = (1, -1, 1, 1)
        if self.training:
            xf = x.float()
            if self.sync is None:
                mean = xf.mean(dim=(0, 2, 3))
                sq = (xf * xf).mean(dim=(0, 2, 3))
            else:
                n = float(xf.numel() // xf.shape[1] * self.sync.dp)
                mean = self.sync.sum(xf.sum(dim=(0, 2, 3))) / n
                sq = self.sync.sum((xf * xf).sum(dim=(0, 2, 3))) / n
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean
                                        + (1 - 0.9) * mean)
                self.running_var.copy_(0.9 * self.running_var
                                       + (1 - 0.9) * var)
            mul = torch.rsqrt(var + BN_EPS) * self.weight
            y = (xf - mean.view(shape)) * mul.view(shape)
            return (y + self.bias.view(shape)).to(dt)
        mean = self.running_mean.to(dt).view(shape)
        var = self.running_var.to(dt).view(shape)
        mul = torch.rsqrt(var + BN_EPS) * self.weight.to(dt).view(shape)
        return (x - mean) * mul + self.bias.to(dt).view(shape)


class ConvBNRelu(nn.Module):
    """conv (+ BN) + ReLU; the conv carries a bias only without BN."""

    def __init__(self, cin: int, cout: int, kernel=3, stride=1,
                 padding="SAME", use_bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, padding,
                           bias=not use_bn, dtype=dtype)
        self.bn = BatchNorm(cout) if use_bn else None

    def forward(self, x):
        tp = self.conv.tp
        if tp is not None:              # column-parallel: local channels
            x = tp.copy(x)
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        x = F.relu(x)
        return x if tp is None else tp.gather(x, dim=1)


def flip_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverses each sample's first lengths[b] steps of (B, T, F); later
    steps stay in place. Its own inverse."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    L = lengths.to(x.device).long()[:, None]
    idx = torch.where(t < L, L - 1 - t, t)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def lstm_column_parallel(lstm: nn.LSTM, x: torch.Tensor, tp) -> torch.Tensor:
    """nn.LSTM's recurrence over (B, T, F) with each gate's rows split over
    tp: the local weights hold H/tp rows of each of the i, f, g, o blocks,
    so each rank computes its slice of every gate and of the cell, and the
    hidden state is all-gathered every frame for the next contraction."""
    w_ih, w_hh = lstm.weight_ih_l0, lstm.weight_hh_l0
    hl = w_hh.shape[0] // 4
    xw = F.linear(tp.copy(x), w_ih, lstm.bias_ih_l0 + lstm.bias_hh_l0)
    B, T = x.shape[:2]
    h = x.new_zeros(B, hl * tp.size)
    c = x.new_zeros(B, hl)
    out = []
    for t in range(T):
        g = (xw[:, t] + F.linear(tp.copy(h), w_hh)).view(B, 4, hl)
        c = torch.sigmoid(g[:, 1]) * c + torch.sigmoid(g[:, 0]) * torch.tanh(
            g[:, 2])
        h = tp.gather(torch.sigmoid(g[:, 3]) * torch.tanh(c), dim=1)
        out.append(h)
    return torch.stack(out, dim=1)


class BiLSTM(nn.Module):
    """Bidirectional LSTM with a length-aware reverse pass. With `tp`
    both directions run lstm_column_parallel in place of cuDNN's LSTM."""

    tp = None

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.fwd = nn.LSTM(input_size, hidden, batch_first=True)
        self.bwd = nn.LSTM(input_size, hidden, batch_first=True)

    def _run(self, lstm: nn.LSTM, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return lstm(x)[0]
        return lstm_column_parallel(lstm, x, self.tp)

    def forward(self, x, lengths):
        yf = self._run(self.fwd, x)
        yb = self._run(self.bwd, flip_valid(x, lengths))
        return torch.cat([yf, flip_valid(yb, lengths)], dim=-1)


class CRNN(nn.Module):
    """Conv stack -> BiLSTM x2 -> projection to (B, T, num_classes) logits.

    forward(images (B, 1, H, W) normalized grayscale, widths (B,) valid
    pixel widths) -> (logits (B, T, C) float32, frame_lengths (B,) int32),
    T = W // 4. With `tp` the projection is column-parallel over the
    classes.
    """

    tp = None
    arch = "crnn"

    def __init__(self, num_classes: int, hidden: int = 256,
                 channels: Sequence[int] = (64, 128, 256, 512),
                 input_height: int = INPUT_HEIGHT,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if input_height % 16:
            raise ValueError(f"input_height {input_height} must be a "
                             "multiple of 16")
        c1, c2, c3, c4 = channels
        self.input_height = input_height
        kw = dict(dtype=dtype)
        self.conv0 = ConvBNRelu(1, c1, use_bn=False, **kw)
        self.conv1 = ConvBNRelu(c1, c2, use_bn=False, **kw)
        self.conv2 = ConvBNRelu(c2, c3, **kw)
        self.conv3 = ConvBNRelu(c3, c3, use_bn=False, **kw)
        self.conv4 = ConvBNRelu(c3, c4, **kw)
        self.conv5 = ConvBNRelu(c4, c4, use_bn=False, **kw)
        # collapse the remaining H/16 rows: VALID in H, pad 1 in W
        self.conv6 = ConvBNRelu(c4, c4, kernel=(input_height // 16, 3),
                                padding=((0, 0), (1, 1)), **kw)
        self.lstm0 = BiLSTM(c4, hidden)
        self.lstm1 = BiLSTM(2 * hidden, hidden)
        self.fc = nn.Linear(2 * hidden, num_classes)

    def forward(self, images: torch.Tensor,
                widths: Optional[torch.Tensor] = None):
        B, _, H, W = images.shape
        if H != self.input_height:
            raise ValueError(f"CRNN expects height {self.input_height}, "
                             f"got {H}")
        if W % WIDTH_STRIDE:
            raise ValueError(f"width {W} must be a multiple of {WIDTH_STRIDE}")
        if widths is None:
            widths = torch.full((B,), W, dtype=torch.int32,
                                device=images.device)
        x = self.conv0(images)
        x = F.max_pool2d(x, 2, 2)
        x = self.conv1(x)
        x = F.max_pool2d(x, 2, 2)
        x = self.conv3(self.conv2(x))
        x = F.max_pool2d(x, (2, 1), (2, 1))
        x = self.conv5(self.conv4(x))
        x = F.max_pool2d(x, (2, 1), (2, 1))
        x = self.conv6(x)                                   # (B, C, 1, T)
        feats = x[:, :, 0].permute(0, 2, 1).float()         # (B, T, C)
        frame_lengths = torch.clamp(
            -(-widths.long() // WIDTH_STRIDE), 0, feats.shape[1]
        ).to(torch.int32)
        feats = self.lstm0(feats, frame_lengths)
        feats = self.lstm1(feats, frame_lengths)
        if self.tp is not None:
            return self.tp.gather(self.fc(self.tp.copy(feats)), dim=-1), \
                frame_lengths
        return self.fc(feats), frame_lengths


def compute_dtype(config) -> torch.dtype:
    return getattr(torch, config.compute_dtype)


def rec_dtype(config) -> torch.dtype:
    """The recognizer's compute dtype: rec_compute_dtype, else
    compute_dtype."""
    return getattr(torch, config.rec_compute_dtype or config.compute_dtype)


def create_crnn(config, num_classes: int) -> CRNN:
    return CRNN(num_classes=num_classes, hidden=config.rec_hidden,
                channels=tuple(config.rec_conv_channels),
                input_height=config.rec_height, dtype=rec_dtype(config))
