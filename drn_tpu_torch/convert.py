"""Weight bridge: the JAX package's flax params → the port's state_dict.

`flax_params_to_state_dict` takes the `{"params": ...}` tree of the JAX
package's `DRN.init` (or an Orbax restore) as numpy arrays and returns a
state_dict in the `TorchDRNParity` schema, the one `DRN.load_state_dict`
takes. Layout changes:

  * conv kernel (K, Cin, Cout)            → Conv1d weight (Cout, Cin, K)
  * Dense kernel (Cin, Cout)              → Linear weight (Cout, Cin)
  * LSTM cell {ii,if,ig,io}.kernel (In, H) → weight_ih_l0 (4H, In), gate rows
    [i, f, g, o]; {h*}.kernel → weight_hh_l0; the flax h* bias → bias_ih_l0,
    bias_hh_l0 = 0 (flax keeps one bias per gate)
  * LayerNorm scale/bias                  → weight/bias
  * heads scale_l (scalars)               → scales (L,)

`load_torch_checkpoint` reads a parity-schema `.pth` (a raw state_dict or
{"model": state_dict}).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from drn_tpu_torch.config import ModelConfig

_GATES = ("i", "f", "g", "o")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(sd, name: str, p) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    sd[f"{name}.bias"] = _t(p["bias"])


def _dense(sd, name: str, p) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def _ln(sd, name: str, p) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _conv_block(sd, name: str, p) -> None:
    _conv(sd, f"{name}.conv", p["Conv_0"])
    if "LayerNorm_0" in p:
        _ln(sd, f"{name}.norm", p["LayerNorm_0"])


def _lstm(sd, name: str, cell) -> None:
    sd[f"{name}.weight_ih_l0"] = _t(np.concatenate(
        [np.asarray(cell[f"i{g}"]["kernel"]).T for g in _GATES]))
    sd[f"{name}.weight_hh_l0"] = _t(np.concatenate(
        [np.asarray(cell[f"h{g}"]["kernel"]).T for g in _GATES]))
    bias = _t(np.concatenate([np.asarray(cell[f"h{g}"]["bias"])
                              for g in _GATES]))
    sd[f"{name}.bias_ih_l0"] = bias
    sd[f"{name}.bias_hh_l0"] = torch.zeros_like(bias)


def flax_params_to_state_dict(params: Dict[str, Any],
                              cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """{"params": tree} (numpy leaves) → parity-schema state_dict (fp32)."""
    p = params["params"]
    sd: Dict[str, torch.Tensor] = {}

    qe = p["query_encoder"]
    sd["embed.weight"] = _t(qe["embedding"]["embedding"])
    for i in range(cfg.num_lstm_layers):
        _lstm(sd, f"lstm_fwd.{i}", qe[f"OptimizedLSTMCell_{2 * i}"])
        _lstm(sd, f"lstm_bwd.{i}", qe[f"OptimizedLSTMCell_{2 * i + 1}"])
    for l in range(cfg.num_levels):
        _dense(sd, f"query_proj.{l}", qe[f"query_proj_{l}"])

    bb = p["backbone"]
    _ln(sd, "input_norm", bb["input_norm"])
    _conv_block(sd, "stem", bb["stem"])
    for l in range(cfg.num_levels):
        _conv_block(sd, f"levels.{l}", bb[f"level_{l}"])

    for l in range(cfg.num_levels):
        fu = p[f"fusion_{l}"]
        _conv(sd, f"fusion_conv.{l}", fu)
        _ln(sd, f"fusion_norm.{l}", fu["LayerNorm_0"])

    for l in range(cfg.num_levels):
        _conv_block(sd, f"lateral.{l}", p["fpn"][f"lateral_{l}"])
        _conv_block(sd, f"smooth.{l}", p["fpn"][f"smooth_{l}"])

    hd = p["heads"]
    for i in range(cfg.head_tower_layers):
        _conv_block(sd, f"loc_tower.{i}", hd["loc"][f"tower_{i}"])
        _conv_block(sd, f"match_tower.{i}", hd["match"][f"tower_{i}"])
    _conv(sd, "loc_out", hd["loc"]["out"])
    _conv(sd, "match_out", hd["match"]["out"])
    sd["scales"] = _t([np.asarray(hd[f"scale_{l}"]).reshape(())
                       for l in range(cfg.num_levels)])

    iou = p["iou_head"]
    for i in range(cfg.iou_head_layers):
        _conv_block(sd, f"iou_mix.{i}", iou[f"mix_{i}"])
    _conv(sd, "iou_out", iou["out"])
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A parity-schema `.pth` → state_dict (unwraps {"model": ...})."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        return obj["model"]
    return obj
