"""The multimodal siamese's plain float32 twin: two modality pre-nets, a
learned attention gate fusing their outputs per frame, a post-net;
coscos2 over aligned frame pairs; adadelta with the gate's parameters at
their own learning rate. Imports nothing of the program.

Per frame of one siamese branch, all activations sigmoid (sigma):

- h_A = sigma(x_A W_A0 + b_A0), e_A = sigma(h_A W_A1 + b_A1)   (``pre_0``)
- h_B = sigma(x_B W_B0 + b_B0), e_B = sigma(h_B W_B1 + b_B1)   (``pre_1``)
- alpha = sigma((d_A v_1 + c_1) + (d_B v_2 + c_2)), (N, 1), where d is
  what the gate reads: the pre-nets' outputs e (``asynchronous_
  integration_index`` None) or the input of their layer k (index k: 0 the
  raw frames, 1 the activations h); a gate branch of more than one layer
  has sigma after each but its last (``integration/linear1``, ``linear2``)
- z = alpha e_A + (1 - alpha) e_B   (``integration_mode`` "sum")
- out = sigma(sigma(z P_0 + p_0) P_1 + p_1)   (``post``)

(reference abnet3 integration.py:345-475, model.py:379-621). The loss is
the mean over the aligned frame pairs of (1 - cos)/2 (same word) or cos^2
(different words); the update is adadelta's at ``optimizer.lr`` for every
parameter but the gate's, which take ``attention_lr`` (reference
model.py:512-528). Departures: the weights come from the caller (the
reference draws them from torch's global generator); dropout 0 and no
batch norm, as the configuration states, so neither is written here.
``fixed_gate`` holds alpha at a constant (a planted fault: a gate that
learns nothing).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from h100_bench.reference import numerics


class Frames(NamedTuple):
    """The loss terms of a batch: per aligned frame pair, the two frames of
    each modality and the +1 (same word) / -1 label."""
    xa1: torch.Tensor
    xb1: torch.Tensor
    xa2: torch.Tensor
    xb2: torch.Tensor
    y: torch.Tensor


def shapes(values: dict) -> dict:
    """(in, out) of every layer by its path, the input layer of modality A
    first."""
    out = {}
    towers = [(f"pre_{i}", p) for i, p in
              enumerate(values["pre_integration_net_params"])]
    towers += [(f"integration/linear{i + 1}", p) for i, p in
               enumerate(values["integration_net_params"])]
    towers.append(("post", values["post_integration_net_params"]))
    for path, p in towers:
        for k, (a, b) in enumerate(zip(p[:-1], p[1:])):
            out[f"{path}/layer_{k}"] = (a, b)
    return out


def init_weights(values: dict, gen, device) -> dict:
    """Weights {path/w: U(-a, a), a = sqrt(6 / (fan_in + fan_out)) (xavier
    uniform, sigmoid's gain 1), path/b: 0} drawn in one call."""
    sh = shapes(values)
    sizes = [a * b for a, b in sh.values()]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (path, (fi, fo)), n in zip(sh.items(), sizes):
        a = (6.0 / (fi + fo)) ** 0.5
        out[f"{path}/w"] = (u[at:at + n].view(fi, fo) * 2 - 1) * a
        out[f"{path}/b"] = torch.zeros(fo, device=device)
        at += n
    return out


def _layers(params: dict, path: str):
    k, out = 0, []
    while f"{path}/layer_{k}/w" in params:
        out.append((params[f"{path}/layer_{k}/w"],
                    params[f"{path}/layer_{k}/b"]))
        k += 1
    return out


def _tower(params: dict, path: str, x, last_act: bool = True):
    """x through the tower at ``path``: (output, the input of each
    layer)."""
    inputs = []
    layers = _layers(params, path)
    for k, (w, b) in enumerate(layers):
        inputs.append(x)
        x = numerics.matmul(x, w) + b
        if last_act or k < len(layers) - 1:
            x = torch.sigmoid(x)
    return x, inputs


def _gate(values, params, ea, eb, ins_a, ins_b):
    """alpha (N, 1) from the pre-nets' outputs and layer inputs."""
    idx = values["asynchronous_integration_index"]
    da, db = (ea, eb) if idx is None else (ins_a[idx], ins_b[idx])
    g1, _ = _tower(params, "integration/linear1", da, last_act=False)
    g2, _ = _tower(params, "integration/linear2", db, last_act=False)
    return torch.sigmoid(g1 + g2)


def forward(values: dict, params: dict, xa, xb,
            fixed_gate: Optional[float] = None):
    """The embeddings (N, out) of frames xa (N, d_A), xb (N, d_B)."""
    assert values["integration_mode"] == "sum"
    ea, ins_a = _tower(params, "pre_0", xa)
    eb, ins_b = _tower(params, "pre_1", xb)
    alpha = (_gate(values, params, ea, eb, ins_a, ins_b)
             if fixed_gate is None else fixed_gate)
    z = ea * alpha + eb * (1.0 - alpha)
    out, _ = _tower(params, "post", z)
    return out


def cosine(a, b, eps: float = 1e-6):
    """Row-wise cosine, each norm clamped at eps (torch's
    CosineSimilarity)."""
    na = torch.sqrt((a * a).sum(1)).clamp(min=eps)
    nb = torch.sqrt((b * b).sum(1)).clamp(min=eps)
    return (a * b).sum(1) / (na * nb)


def loss(values: dict, params: dict, f: Frames,
         fixed_gate: Optional[float] = None) -> torch.Tensor:
    """coscos2 over the frame pairs of ``f``: the mean of (1 - cos)/2
    (y = +1) or cos^2 (y = -1)."""
    e1 = forward(values, params, f.xa1, f.xb1, fixed_gate)
    e2 = forward(values, params, f.xa2, f.xb2, fixed_gate)
    cos = cosine(e1, e2)
    return torch.where(f.y > 0, (1.0 - cos) / 2.0, cos * cos).mean()


def head_dims(values: dict) -> list:
    """The widths of the embeddings the loss compares."""
    return [values["post_integration_net_params"][-1]]


def is_attention(key: str) -> bool:
    """Whether the parameter at ``key`` is the gate's (its own group)."""
    return key.startswith("integration/")


def learning_rate(values: dict, key: str) -> float:
    if is_attention(key) and values.get("attention_lr"):
        return values["attention_lr"]
    return values["optimizer"]["lr"]


def run_steps(values: dict, params: Dict[str, torch.Tensor],
              batches: List[Frames], state: Optional[dict] = None,
              fixed_gate: Optional[float] = None) -> dict:
    """The adadelta steps of ``batches`` from ``params`` and the state
    ``state`` ({key: (v, u)}, zeros where None; both copied): each step's
    loss, the first step's gradient and the parameters after the last.
    Adadelta (Zeiler 2012, as torch writes it): v = rho v + (1 - rho) g^2,
    delta = sqrt(u + eps) / sqrt(v + eps) g, u = rho u + (1 - rho)
    delta^2, p -= lr delta, with lr the parameter's group's."""
    opt = values["optimizer"]
    rho, eps = opt["rho"], opt["eps"]
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    st = {k: (v.detach().clone(), u.detach().clone())
          for k, (v, u) in (state or {}).items()}
    losses, first_grad = [], None
    for f in batches:
        for v in p.values():
            v.grad = None
        value = loss(values, p, f, fixed_gate)
        value.backward()
        grads = {k: (v.grad.detach().clone() if v.grad is not None
                     else torch.zeros_like(v)) for k, v in p.items()}
        if first_grad is None:
            first_grad = grads
        losses.append(float(value.detach()))
        with torch.no_grad():
            for k, q in p.items():
                g = grads[k]
                v, u = st.setdefault(k, (torch.zeros_like(q),
                                         torch.zeros_like(q)))
                v.mul_(rho).add_((1 - rho) * g * g)
                delta = torch.sqrt(u + eps) / torch.sqrt(v + eps) * g
                u.mul_(rho).add_((1 - rho) * delta * delta)
                q.sub_(learning_rate(values, k) * delta)
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: v.detach() for k, v in p.items()}}
