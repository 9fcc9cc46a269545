"""Policy weight export for native inference (counterpart of
``d3d12renderer_tpu/learning/export.py``): the policy tower and action
head of an `ActorCritic` as C arrays (`network.h`), weights stored
[out][in] as the engine's hand-written tanh MLP reads them.  numpy only."""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

from .networks import ActorCritic

_LAYERS = ("pi_0", "pi_1", "action_head")


def _extract_mlp(params: Union[ActorCritic, Mapping]):
    """[(w (in, out), b)] of the policy tower and action head, from an
    ActorCritic or its state_dict (`TrainState.params`)."""
    p = params.state_dict() if isinstance(params, torch.nn.Module) else params

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    return [(host(p[f"{n}.weight"]).T, host(p[f"{n}.bias"]))
            for n in _LAYERS]


def _c_array(name: str, arr: np.ndarray) -> str:
    if arr.ndim == 1:
        body = ", ".join(f"{v:.8f}f" for v in arr)
        return f"static const float {name}[{arr.shape[0]}] = {{ {body} }};\n"
    rows = []
    for r in arr:
        rows.append("  { " + ", ".join(f"{v:.8f}f" for v in r) + " }")
    return (f"static const float {name}[{arr.shape[0]}][{arr.shape[1]}] = "
            "{\n" + ",\n".join(rows) + "\n};\n")


def export_policy_header(params, path: str):
    """Write network.h-style C arrays of the policy (weights [out][in])."""
    (w1, b1), (w2, b2), (wo, bo) = _extract_mlp(params)
    with open(path, "w") as f:
        f.write("// Auto-generated policy weights (tanh MLP).\n")
        f.write(f"#define INPUT_SIZE {w1.shape[0]}\n")
        f.write(f"#define HIDDEN_LAYER_SIZE {w1.shape[1]}\n")
        f.write(f"#define OUTPUT_SIZE {wo.shape[1]}\n\n")
        f.write(_c_array("policyWeights1", w1.T))
        f.write(_c_array("policyBias1", b1))
        f.write(_c_array("policyWeights2", w2.T))
        f.write(_c_array("policyBias2", b2))
        f.write(_c_array("actionWeights", wo.T))
        f.write(_c_array("actionBias", bo))


def policy_forward_np(params, obs: np.ndarray) -> np.ndarray:
    """numpy mirror of the exported network (the deterministic action, the
    mean), for checking an export against the policy's forward."""
    (w1, b1), (w2, b2), (wo, bo) = _extract_mlp(params)
    a = np.tanh(obs @ w1 + b1)
    a = np.tanh(a @ w2 + b2)
    return a @ wo + bo
