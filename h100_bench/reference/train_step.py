"""A train step of ABnet3 on word pairs, plainly (float32, TF32 off).

Same-word pairs are aligned frame by frame along their DTW path under
the angular distance; different-word pairs are cut to the shorter word
and aligned on the diagonal. Every aligned frame pair is one term of
the loss, which is the mean of the terms. The gradient comes from
autograd; the update is adadelta's.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from h100_bench.reference import dtw, numerics


class Cells(NamedTuple):
    """The loss terms of a batch: frames x (N, d) of every token of the
    batch, and per term the rows of its two frames, its +1/-1 word label
    and its +1/-1 speaker label."""
    x: torch.Tensor
    rows1: torch.Tensor
    rows2: torch.Tensor
    y: torch.Tensor
    y_spk: torch.Tensor


def batch_cells(same: List[tuple], diff: List[tuple], device,
                keep: Optional[np.ndarray] = None) -> Cells:
    """``same``/``diff``: (frames1, frames2, same_speaker) of each pair.
    ``keep`` (a bool per pair, same pairs first) leaves pairs out."""
    pairs = [(a, b, s, True) for a, b, s in same] + \
        [(a, b, s, False) for a, b, s in diff]
    if keep is not None:
        pairs = [p for p, k in zip(pairs, keep) if k]
    toks, r1, r2, y, ys = [], [], [], [], []
    off = 0
    same_idx = [k for k, p in enumerate(pairs) if p[3]]
    paths = {}
    if same_idx:
        x1, n1 = dtw.pad([pairs[k][0] for k in same_idx], device)
        x2, n2 = dtw.pad([pairs[k][1] for k in same_idx], device)
        _, _, moves = dtw.dp(dtw.angular_distance(x1, x2), n1, n2)
        for k, cells in zip(same_idx, dtw.path_cells(
                moves, n1.cpu().numpy(), n2.cpu().numpy())):
            paths[k] = cells
    for k, (a, b, s, is_same) in enumerate(pairs):
        if is_same:
            i, j = paths[k]
        else:
            i = j = np.arange(min(len(a), len(b)))
        toks += [a, b]
        r1.append(off + i)
        r2.append(off + len(a) + j)
        y.append(np.full(len(i), 1.0 if is_same else -1.0, np.float32))
        ys.append(np.full(len(i), 1.0 if s else -1.0, np.float32))
        off += len(a) + len(b)

    def put(parts, dtype):
        return torch.from_numpy(np.concatenate(parts).astype(dtype)).to(
            device)
    return Cells(put(toks, np.float32), put(r1, np.int64), put(r2, np.int64),
                 put(y, np.float32), put(ys, np.float32))


def cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6):
    """Row-wise cosine, each norm clamped at eps (torch's
    CosineSimilarity)."""
    na = torch.sqrt((a * a).sum(1)).clamp(min=eps)
    nb = torch.sqrt((b * b).sum(1)).clamp(min=eps)
    return (a * b).sum(1) / (na * nb)


def coscos2(e: torch.Tensor, c: Cells, y: torch.Tensor) -> torch.Tensor:
    """Mean over the terms of (1 - cos)/2 (y = +1) or cos^2 (y = -1)."""
    cos = cosine(e[c.rows1], e[c.rows2])
    return torch.where(y > 0, (1.0 - cos) / 2.0, cos * cos).mean()


def mlp(layers, x: torch.Tensor, act: str) -> torch.Tensor:
    """x @ w + b then the activation, layer by layer."""
    f = {"sigmoid": torch.sigmoid, "relu": torch.relu,
         "tanh": torch.tanh}[act]
    for w, b in layers:
        x = f(numerics.matmul(x, w) + b)
    return x


def xavier_uniform(gen: torch.Generator, shapes: Dict[str, tuple],
                   device) -> Dict[str, torch.Tensor]:
    """Weights {path/w: U(-a, a), a = sqrt(6 / (fan_in + fan_out)) (gain
    1, sigmoid's), path/b: 0} drawn in one call on ``device``."""
    sizes = [a * b for a, b in shapes.values()]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (path, (fi, fo)), n in zip(shapes.items(), sizes):
        a = (6.0 / (fi + fo)) ** 0.5
        out[f"{path}/w"] = (u[at:at + n].view(fi, fo) * 2 - 1) * a
        out[f"{path}/b"] = torch.zeros(fo, device=device)
        at += n
    return out


def adadelta(params: Dict[str, torch.Tensor], grads, state, lr: float,
             rho: float, eps: float) -> None:
    """One adadelta update in place (Zeiler 2012, as torch and optax
    write it): v = rho v + (1 - rho) g^2, delta = sqrt(u + eps) /
    sqrt(v + eps) g, u = rho u + (1 - rho) delta^2, p -= lr delta."""
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            v, u = state.setdefault(k, (torch.zeros_like(p),
                                        torch.zeros_like(p)))
            v.mul_(rho).add_((1 - rho) * g * g)
            delta = torch.sqrt(u + eps) / torch.sqrt(v + eps) * g
            u.mul_(rho).add_((1 - rho) * delta * delta)
            p.sub_(lr * delta)


def run_steps(loss_fn, params: Dict[str, torch.Tensor], batches: List[Cells],
              opt: dict, state: Optional[dict] = None) -> dict:
    """The steps of ``batches`` from ``params`` and adadelta's ``state``
    ({key: (v, u)}, zeros where None; both copied): each step's loss,
    the first step's gradient and the parameters after the last."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    state = {k: (v.detach().clone(), u.detach().clone())
             for k, (v, u) in (state or {}).items()}
    losses, first_grad = [], None
    for c in batches:
        for v in p.values():
            v.grad = None
        loss = loss_fn(p, c)
        loss.backward()
        grads = {k: v.grad.detach().clone() for k, v in p.items()}
        if first_grad is None:
            first_grad = grads
        losses.append(float(loss.detach()))
        adadelta(p, grads, state, opt["lr"], opt["rho"], opt["eps"])
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: v.detach() for k, v in p.items()}}
