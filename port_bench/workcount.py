"""Operations and bytes of a model part, counted from the configuration's
shapes: the functions that `port_bench/work/<part>.py` build on.

A product counts 2·M·N·K operations. Bytes count each input and each
weight read once and each output written once, in the type the program
runs them in (activations and weights bfloat16, the staged features
fp32). The backward of a product is two products of the forward's size:
the input's gradient (dX) and the weight's (dW).
"""

from __future__ import annotations

from typing import Dict, List

BF16, FP32 = 2, 4


def sizes(dims) -> List[int]:
    return [dims["num_clips"] // 2 ** l for l in range(dims["num_levels"])]


def conv(batch: int, t_out: int, cin: int, cout: int, k: int, t_in: int,
         in_bytes: int = BF16, out_bytes: int = BF16) -> Dict[str, float]:
    """One SAME conv (k taps) of `batch` rows of t_in → t_out positions."""
    return {"flops": 2.0 * batch * t_out * cin * cout * k,
            "bytes": float(batch * t_in * cin * in_bytes
                           + k * cin * cout * BF16
                           + batch * t_out * cout * out_bytes)}


def total(parts) -> Dict[str, float]:
    out = {"flops": 0.0, "bytes": 0.0}
    for p in parts:
        out["flops"] += p["flops"]
        out["bytes"] += p["bytes"]
    return out


def trained(fwd: Dict[str, float], with_grad: bool = True
            ) -> Dict[str, float]:
    """Forward, dX and dW of a part that gets a gradient (three times the
    forward's products, and as a bound three times its bytes); the forward
    alone for one that gets none."""
    n = 3.0 if with_grad else 1.0
    return {"flops": n * fwd["flops"], "bytes": n * fwd["bytes"]}
