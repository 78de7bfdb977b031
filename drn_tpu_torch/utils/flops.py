"""Matmul + conv FLOP count of one call (port of drn_tpu/utils/flops.py).

The JAX package walks a traced jaxpr. The port runs the call once under
`torch.utils.flop_counter.FlopCounterMode`, which counts every aten matrix
product and convolution in the same 2×MAC convention, forward and
backward. Element-wise and reduction work is not counted, as in the JAX
package, so the result is a lower bound. Two kinds of work the mode does
not see are counted here in the same convention:

  * the hand-written kernels: a ctypes launch is invisible to the mode, so
    each wrapper calls `add_conv` where it launches its kernel, with its
    conv's 2·B·T_out·Cin·Cout·K. On a CPU tensor a wrapper runs its plain
    version instead, whose K tap products the mode counts: the same
    number, and nothing is counted twice.
  * recurrent layers: `nn.LSTM` (and GRU, RNN) runs as one fused aten op,
    cuDNN's on the card and oneDNN's on the CPU, that the mode has no
    formula for. `RNN_FORMULAS` gives each one: the gate products, T·B
    rows × 2·Σ(in·G·H + H·G·H) over layers and directions (G = 4 gates
    for an LSTM), the sum of the layer's weight matrices' sizes; a
    backward pass counts the data gradients (the same products again) and
    the weight gradients (again) where it takes them. A route that splits
    the recurrence into matrix products is counted by the mode itself.

So the count of a call does not depend on whether it ran on the card,
through the kernels, or on the CPU, through the plain versions.
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten

# The kernel FLOPs of each estimate in progress (`add_conv` adds to all).
_active: List[List[int]] = []


def add_conv(b: int, t_out: int, cin: int, cout: int, k: int) -> None:
    """Count one launch of a conv kernel, 2·B·T_out·Cin·Cout·K, into every
    `estimate_flops` in progress (none: nothing happens)."""
    for count in _active:
        count[0] += 2 * b * t_out * cin * cout * k


def _gate_macs(weights) -> int:
    """MACs per input row of the weight matrices given (biases left out)."""
    return sum(math.prod(w) for w in weights if w is not None and len(w) == 2)


def _rows(input_shape) -> int:
    """T·B: (T, B, in) or (B, T, in), or (ΣB_t, in) for a packed input."""
    return math.prod(input_shape[:-1])


def _cudnn_rnn(input, weight, *args, out_shape=None, **kw) -> int:
    return 2 * _rows(input) * _gate_macs(weight)


def _cudnn_rnn_backward(input, weight, *args, out_shape=None, **kw) -> int:
    output_mask = args[-1]  # (input, hx, cx, weight) gradients wanted
    return (1 + bool(output_mask[3])) * _cudnn_rnn(input, weight)


def _mkldnn_rnn_layer(input, w_ih, w_hh, *args, out_shape=None, **kw) -> int:
    return 2 * _rows(input) * _gate_macs((w_ih, w_hh))


def _mkldnn_rnn_layer_backward(input, w_ih, w_hh, *args, out_shape=None,
                               **kw) -> int:
    return 2 * _mkldnn_rnn_layer(input, w_ih, w_hh)


RNN_FORMULAS = {
    aten._cudnn_rnn: _cudnn_rnn,
    aten._cudnn_rnn_backward: _cudnn_rnn_backward,
    aten.mkldnn_rnn_layer: _mkldnn_rnn_layer,
    aten.mkldnn_rnn_layer_backward: _mkldnn_rnn_layer_backward,
}


def estimate_flops(fn, *args, **kwargs) -> float:
    """Matmul + conv FLOPs of one call of `fn(*args, **kwargs)` (2×MAC
    convention). Runs the call once, on whatever device its inputs are."""
    count = [0]
    _active.append(count)
    try:
        with FlopCounterMode(display=False,
                             custom_mapping=RNN_FORMULAS) as mode:
            fn(*args, **kwargs)
    finally:
        _active.remove(count)
    return float(mode.get_total_flops() + count[0])
