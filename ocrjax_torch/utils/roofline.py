"""Roofline accounting for the bench (port of ocrjax/utils/roofline.py).

FLOP counts come from torch.utils.flop_counter.FlopCounterMode, which runs
the program once more and counts the matrix products and convolutions it
dispatches (ocrjax asks XLA's cost model of the lowered program instead).
PyTorch's counter has no formula for the LSTM, so this module adds one for
aten.lstm, the op an nn.LSTM dispatches: 8 gate products a step and
direction, as crnn_bilstm_flops counts them. Element-wise work and the
hand-written kernels (K1) are not counted, as XLA's model did not count
the Pallas kernels.

The peak is the NVIDIA H100 SXM's dense bf16 tensor-core rate (NVIDIA's
data sheet, at the full 700 W power limit).
"""

from __future__ import annotations

import torch

H100_SXM_BF16_PEAK_TFLOPS = 989.0


def _rnn_flops(in_shape, hidden: int, num_layers: int, bidirectional: bool,
               batch_first: bool) -> int:
    """2 FLOPs a MAC over 4 gates of (in -> H) and (H -> H), every step,
    layer and direction; layers after the first read the H * dirs output."""
    T, B = (in_shape[1], in_shape[0]) if batch_first else in_shape[:2]
    dirs = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        n_in = in_shape[2] if layer == 0 else hidden * dirs
        total += dirs * T * B * 2 * 4 * hidden * (n_in + hidden)
    return total


def _lstm_flops(input, hx, params, has_biases, num_layers, dropout, train,
                bidirectional, batch_first, out_shape=None) -> int:
    return _rnn_flops(input, params[1][1], num_layers, bidirectional,
                      batch_first)


def torch_flops(fn, *args) -> float:
    """FLOPs that `fn(*args)` dispatches (matrix products, convolutions and
    LSTMs). Runs fn once more, op by op (a graph's replay dispatches
    nothing to count): call it outside every timed window."""
    from torch.utils.flop_counter import FlopCounterMode

    from ocrjax_torch import graphs
    lstm = torch.ops.aten.lstm
    # the overload keeps the mode from decomposing the LSTM into ops it
    # does not count; the packet names the formula
    mapping = {lstm: _lstm_flops, lstm.input: _lstm_flops}
    with torch.inference_mode(), graphs.eager(), FlopCounterMode(
            display=False, custom_mapping=mapping) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def crnn_bilstm_flops(cfg, n: int, width: int) -> float:
    """Analytic matmul FLOPs of the 2-layer BiLSTM over one batch.

    The conv stack collapses H and downsamples W by 4 (models/crnn.py), so
    the scan runs T = width/4 steps. Per direction and step, an LSTM cell
    computes 8 gate matmuls: 4x (in -> H) + 4x (H -> H), 2 FLOPs per MAC.
    Layer 1 input = last conv width; layer 2 input = 2H (the concatenated
    bidirectional output of layer 1)."""
    T = max(width // 4, 1)
    H = cfg.rec_hidden
    in1 = cfg.rec_conv_channels[-1]
    in2 = 2 * H
    # per direction, per step, both layers; inner 2 = FLOPs per MAC
    per_step = 4 * 2 * (in1 * H + H * H) + 4 * 2 * (in2 * H + H * H)
    return float(2 * T * n * per_step)  # leading 2 = directions


def stage_entry(name: str, flops: float, seconds: float) -> dict:
    """One roofline row: achieved TFLOP/s and % of the H100's bf16 peak."""
    tf = flops / max(seconds, 1e-9) / 1e12
    return {
        "stage": name,
        "gflops": round(flops / 1e9, 2),
        "ms": round(seconds * 1e3, 2),
        "achieved_tflops": round(tf, 2),
        "pct_of_bf16_peak": round(100.0 * tf / H100_SXM_BF16_PEAK_TFLOPS, 2),
    }
