"""Optimizers with optax's semantics, for the optimizer types whose torch
versions compute something else.

The JAX package builds its optimizers with optax (``build_optimizer``,
``abnet3_tpu/trainer.py:72-106``); for ``sgd``, ``adadelta`` and ``adam``
torch's optimizers compute the same updates, for these three they do
not (torch's Adagrad starts its accumulator at 0 with eps outside the
square root, its RMSprop decays by 0.99, its LBFGS has no zoom
linesearch). Each class here writes out optax 0.2.6's transformation
chain with its defaults:

- :class:`Adagrad`, ``optax.adagrad(lr)``: the accumulator starts at 0.1,
  ``acc += g**2``, update ``-lr * g * rsqrt(acc + 1e-7)`` (0 where acc is
  0);
- :class:`RMSprop`, ``optax.rmsprop(lr)``: ``nu = 0.1 * g**2 + 0.9 *
  nu`` from 0, update ``-lr * g * rsqrt(nu + 1e-8)``, no momentum, not
  centered;
- :class:`LBFGS`, ``optax.lbfgs(lr)`` (``scale_by_lbfgs`` with memory 10
  and the scaled initial preconditioner, ``scale(-lr)``, then
  ``scale_by_zoom_linesearch`` with at most 20 steps and the initial
  guess 1) inside the JAX package's ``_finite_step_guard``: a step whose
  update or new state holds a non-finite float is dropped, the
  parameters and the state stay as they were.

:class:`LBFGS` takes the loss of the step's first evaluation and a
closure (:func:`abnet3_torch.parallel.mesh._opt_step`): the closure
evaluates the loss at the current parameters and leaves its gradient in
``.grad``, the twin of optax's ``value_fn``. The linesearch's scalars
live on the host in the parameters' dtype (one read of the loss and the
slope a evaluation: its loop ends on their values); the vectors stay on
the parameters' device.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

__all__ = ["Adagrad", "RMSprop", "LBFGS"]

# optax 0.2.6's defaults, which the JAX package's build_optimizer keeps
_ADAGRAD_INIT, _ADAGRAD_EPS = 0.1, 1e-7
_RMS_DECAY, _RMS_EPS = 0.9, 1e-8
_LBFGS_MEMORY, _LBFGS_MAX_LINESEARCH = 10, 20


def _grad_or_zeros(p: torch.Tensor) -> torch.Tensor:
    """``p.grad``, or zeros where the loss did not reach ``p`` (optax
    updates every leaf)."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr)`` (initial accumulator 0.1, eps 1e-7). Per
    parameter: ``sum_of_squares`` (optax's ``ScaleByRssState``)."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["sum_of_squares"] = torch.full_like(
                    p, _ADAGRAD_INIT)

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                g = _grad_or_zeros(p)
                acc = self.state[p]["sum_of_squares"]
                acc.add_(g * g)
                inv = torch.where(acc > 0, torch.rsqrt(acc + _ADAGRAD_EPS),
                                  0.0)
                p.add_(inv * g * -group["lr"])
        return loss


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr)`` (decay 0.9, eps 1e-8 inside the square root,
    initial scale 0, no momentum, not centered). Per parameter: ``nu``
    (optax's ``ScaleByRmsState``)."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["nu"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                g = _grad_or_zeros(p)
                nu = self.state[p]["nu"]
                nu.copy_((1 - _RMS_DECAY) * (g * g) + _RMS_DECAY * nu)
                p.add_(torch.rsqrt(nu + _RMS_EPS) * g * -group["lr"])
        return loss


class LBFGS(torch.optim.Optimizer):
    """``optax.lbfgs(lr)`` in the finite-step guard (see the module).

    ``step(closure, value)`` reads the gradient of the step's first
    evaluation from ``.grad`` and its loss ``value``; ``closure()``
    re-evaluates the loss and its gradient at the parameters the
    linesearch tries. The state is optax's, over the parameters
    flattened into one vector in ``param_groups`` order: per parameter
    (views into the flat buffers) ``params``, ``updates``,
    ``diff_params_memory`` and ``diff_updates_memory`` (memory_size,
    *shape) of ``ScaleByLBFGSState`` and the linesearch's final ``grad``;
    on the optimizer ``count``, ``weights_memory`` and, of
    ``ScaleByZoomLinesearchState``, ``learning_rate``, ``value`` and the
    info ``num_linesearch_steps``, ``decrease_error``,
    ``curvature_error``.

    Over parameters column-sharded on a mesh's 'model' axis (see
    :func:`abnet3_torch.parallel.mesh.shard_network`) the flat vector is
    this rank's block: every inner product is summed over 'model' (a
    replicated parameter counts once) and the finite-step guard agrees
    across the group, so the ranks take the same steps. The loss values
    the closure returns are global already."""

    takes_closure = True

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))
        if len(self.param_groups) != 1:
            raise ValueError("LBFGS takes one parameter group")
        self.memory_size = memory_size = _LBFGS_MEMORY
        self._params: List[torch.Tensor] = list(
            self.param_groups[0]["params"])
        p0 = self._params[0]
        self._numels = [p.numel() for p in self._params]
        n = sum(self._numels)
        kw = dict(dtype=p0.dtype, device=p0.device)
        self._np = np.dtype(str(p0.dtype).replace("torch.", "")).type
        shards = [getattr(p, "_col_shard", None) for p in self._params]
        self._model = next((sh for sh in shards if sh is not None), None)
        if self._model is not None:
            # a replicated parameter's share of the summed inner product
            self._dot_weight = torch.cat([
                torch.full((k,), 1.0 if sh is not None
                           else 1.0 / self._model.n, **kw)
                for k, sh in zip(self._numels, shards)])
        self._flat = {name: torch.zeros(n, **kw)
                      for name in ("params", "updates", "grad")}
        for name in ("diff_params_memory", "diff_updates_memory"):
            self._flat[name] = torch.zeros((memory_size, n), **kw)
        self.weights_memory = torch.zeros(memory_size, **kw)
        self.count = 0
        c = self._np
        self.learning_rate, self.value = c(1.0), c(np.inf)
        self.num_linesearch_steps = 0
        self.decrease_error, self.curvature_error = c(np.inf), c(np.inf)
        off = 0
        for p, k in zip(self._params, self._numels):
            st = self.state[p]
            for name in ("params", "updates", "grad"):
                st[name] = self._flat[name][off:off + k].view(p.shape)
            for name in ("diff_params_memory", "diff_updates_memory"):
                st[name] = self._flat[name][:, off:off + k].view(
                    (memory_size,) + tuple(p.shape))
            off += k

    # -- flat vectors ------------------------------------------------------

    def _dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The inner product of two flat vectors (over the whole
        parameter vector on a 'model' axis)."""
        if self._model is None:
            return torch.dot(a, b)
        import torch.distributed as dist
        d = torch.dot(a * self._dot_weight, b)
        dist.all_reduce(d, group=self._model.group)
        return d

    def _flat_params(self) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1) for p in self._params])

    def _flat_grads(self) -> torch.Tensor:
        return torch.cat([_grad_or_zeros(p).detach().reshape(-1)
                          for p in self._params])

    def _set_params(self, flat: torch.Tensor) -> None:
        for p, v in zip(self._params, flat.split(self._numels)):
            p.copy_(v.view_as(p))

    def _host(self, *scalars: torch.Tensor):
        """0-d device tensors as host scalars of the parameters' dtype, in
        one read."""
        out = torch.stack([s.to(self._flat["params"].dtype).reshape(())
                           for s in scalars]).cpu().numpy()
        return [self._np(v) for v in out]

    # -- scale_by_lbfgs ------------------------------------------------------

    def _precondition(self, grads: torch.Tensor, x0: torch.Tensor):
        """optax's ``scale_by_lbfgs`` update at the parameters ``x0``: the
        memory row of the last step is written (diffs and weight, zeros at
        the first step), then the two-loop product with the scaled
        identity. Returns the preconditioned gradient and the row it
        overwrote (its index, diffs and weight), for the guard."""
        m = self.memory_size
        mem_idx = self.count % m
        prev = (self.count - 1) % m
        dpm = self._flat["diff_params_memory"]
        dum = self._flat["diff_updates_memory"]
        rho = self.weights_memory
        old_row = (prev, dpm[prev].clone(), dum[prev].clone(),
                   rho[prev].clone())
        if self.count > 0:
            dparams = x0 - self._flat["params"]
            dupdates = grads - self._flat["updates"]
            vdot = self._dot(dupdates, dparams)
            weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
        else:
            dparams = torch.zeros_like(grads)
            dupdates = torch.zeros_like(grads)
            weight = torch.zeros((), dtype=rho.dtype, device=rho.device)
        dpm[prev] = dparams
        dum[prev] = dupdates
        rho[prev] = weight
        if self.count > 0:
            den = self._dot(dupdates, dupdates)
            scale = torch.where(den > 0.0, vdot / den, 1.0)
        else:
            scale = torch.clamp(1.0 / torch.sqrt(self._dot(grads, grads)),
                                max=1.0)
        order = [(mem_idx + k) % m for k in range(m)]
        vec = grads
        alphas = [None] * m
        for k in reversed(range(m)):
            i = order[k]
            alphas[k] = rho[i] * self._dot(dpm[i], vec)
            vec = vec + (-alphas[k]) * dum[i]
        vec = scale * vec
        for k in range(m):
            i = order[k]
            beta = rho[i] * self._dot(dum[i], vec)
            vec = vec + (alphas[k] - beta) * dpm[i]
        return vec, old_row

    # -- step ----------------------------------------------------------------

    @torch.no_grad()
    def step(self, closure: Callable, value: Optional[torch.Tensor] = None):
        """One guarded LBFGS step; returns the loss of the first
        evaluation (``value``, or the closure's when it is not given)."""
        if value is None:
            with torch.enable_grad():
                value = closure()
        grads = self._flat_grads()
        x0 = self._flat_params()
        precond, old_row = self._precondition(grads, x0)
        updates = -self.param_groups[0]["lr"] * precond

        def value_and_slope(stepsize):
            self._set_params(x0 + float(stepsize) * updates)
            with torch.enable_grad():
                v = closure()
            g = self._flat_grads()
            v_host, slope = self._host(v, self._dot(g, updates))
            return v_host, g, slope

        v0, slope0 = self._host(value, self._dot(updates, grads))
        ls = _ZoomLinesearch(self._np, _LBFGS_MAX_LINESEARCH)
        final = ls.run(v0, grads, slope0, value_and_slope)
        lr = final["stepsize"]
        step = float(lr) * updates
        ok = _all_finite(
            [step, x0, grads, self._flat["diff_params_memory"],
             self._flat["diff_updates_memory"], self.weights_memory,
             final["grad"]],
            [lr, final["value"], final["decrease_error"],
             final["curvature_error"]],
            None if self._model is None else self._model.group)
        if not ok:
            prev, dp, du, w = old_row
            self._flat["diff_params_memory"][prev] = dp
            self._flat["diff_updates_memory"][prev] = du
            self.weights_memory[prev] = w
            self._set_params(x0)
        else:
            self._set_params(x0 + step)
            self._flat["params"].copy_(x0)
            self._flat["updates"].copy_(grads)
            self._flat["grad"].copy_(final["grad"])
            self.count = min(self.count + 1, np.iinfo(np.int32).max)
            self.learning_rate, self.value = lr, final["value"]
            self.num_linesearch_steps = final["count"]
            self.decrease_error = final["decrease_error"]
            self.curvature_error = final["curvature_error"]
        return value


def _all_finite(tensors, scalars, group=None) -> bool:
    """Whether every float of ``tensors`` (device) and ``scalars`` (host)
    is finite, with one read of the device; with a ``group``, on every
    rank of it (the tensors are each rank's block)."""
    if not all(np.isfinite(s) for s in scalars):
        return False
    ok = torch.stack([torch.isfinite(t).all() for t in tensors]).all()
    if group is not None:
        import torch.distributed as dist
        ok = ok.to(torch.int32)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
    return bool(ok)


class _ZoomLinesearch:
    """optax 0.2.6's ``zoom_linesearch`` with the defaults of
    ``optax.lbfgs``: tol 0, increase factor 2, slope rtol 1e-4, curvature
    rtol 0.9, approximate-decrease rtol 1e-6, interval threshold 1e-5, no
    largest step, the initial guess 1. Its scalars are host scalars of
    the dtype ``c``; the gradients are device vectors, taken as they
    come."""

    def __init__(self, c, max_steps: int):
        self.c = c
        self.max_steps = max_steps

    def _decrease_error(self, stepsize, value, slope, value_init, slope_init):
        """The sufficient-decrease error, or its approximation where that
        is smaller, at least 0; infinite where it is NaN."""
        c = self.c
        err = value - value_init - c(1e-4) * stepsize * slope_init
        approx = slope - c(2 * 1e-4 - 1.0) * slope_init
        delta = value - value_init - c(1e-6) * abs(value_init)
        if np.isnan(err) or np.isnan(approx) or np.isnan(delta):
            return c(np.inf)
        return c(max(min(max(approx, delta), err), c(0.0)))

    def _curvature_error(self, slope, slope_init):
        c = self.c
        err = abs(slope) - c(0.9) * abs(slope_init)
        if np.isnan(err):
            return c(np.inf)
        return c(max(err, c(0.0)))

    def run(self, value, grad, slope, value_and_slope):
        """The linesearch from the initial (value, grad, slope); returns
        the final state (a dict of optax's field names)."""
        c = self.c
        s = dict(count=0, stepsize=c(0.0), value=value, grad=grad,
                 slope=slope, value_init=value, slope_init=slope,
                 decrease_error=c(np.inf), curvature_error=c(np.inf),
                 interval_found=False, done=False, failed=False,
                 low=c(0.0), value_low=value, slope_low=slope,
                 high=c(0.0), value_high=value, slope_high=slope,
                 cubic_ref=c(0.0), value_cubic_ref=value,
                 safe_stepsize=c(0.0), safe_value=value, safe_grad=grad)
        with np.errstate(all="ignore"):
            while not (s["done"] or s["failed"]):
                if s["interval_found"]:
                    self._zoom(s, value_and_slope)
                else:
                    self._search(s, value_and_slope)
                if s["failed"]:
                    self._safe_step(s)
        return s

    def _errors(self, s, stepsize, value, slope):
        dec = self._decrease_error(stepsize, value, slope, s["value_init"],
                                   s["slope_init"])
        curv = self._curvature_error(slope, s["slope_init"])
        return dec, curv, max(dec, curv)

    def _search(self, s, value_and_slope):
        """``_search_interval``: grow the step until an interval holds a
        point that satisfies both conditions."""
        c = self.c
        new = c(1.0) if s["count"] == 0 else c(2.0) * s["stepsize"]
        value, grad, slope = value_and_slope(new)
        dec, curv, err = self._errors(s, new, value, slope)
        if dec <= 0.0:
            s.update(safe_stepsize=new, safe_value=value, safe_grad=grad)
        set_high = bool(dec > 0.0) or bool(
            value >= s["value"] and s["count"] > 0)
        set_low = bool(slope >= 0.0) and not set_high
        prev = (s["stepsize"], s["value"], s["slope"])
        cur = (new, value, slope)
        lo, hi = (cur, prev) if set_low else (prev, cur)
        done = bool(err <= 0.0)
        s.update(low=lo[0], value_low=lo[1], slope_low=lo[2],
                 high=hi[0], value_high=hi[1], slope_high=hi[2],
                 cubic_ref=lo[0], value_cubic_ref=lo[1],
                 interval_found=set_high or set_low or done,
                 done=done,
                 failed=s["count"] + 1 >= self.max_steps and not done,
                 count=s["count"] + 1, stepsize=new, value=value,
                 grad=grad, slope=slope, decrease_error=dec,
                 curvature_error=curv)

    def _zoom(self, s, value_and_slope):
        """``_zoom_into_interval``: the cubic, else the quadratic, else
        the bisection point of the interval."""
        c = self.c
        low, high = s["low"], s["high"]
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        cubic_chk, quad_chk = c(0.2) * delta, c(0.1) * delta
        too_small = bool(delta <= c(1e-5))
        mc = _cubicmin(c, low, s["value_low"], s["slope_low"], high,
                       s["value_high"], s["cubic_ref"], s["value_cubic_ref"])
        mq = _quadmin(c, low, s["value_low"], s["slope_low"], high,
                      s["value_high"])
        if left + cubic_chk < mc < right - cubic_chk:
            middle = mc
        elif left + quad_chk < mq < right - quad_chk:
            middle = mq
        else:
            middle = (low + high) / c(2.0)
        value, grad, slope = value_and_slope(middle)
        dec, curv, err = self._errors(s, middle, value, slope)
        if dec <= 0.0 and value < s["safe_value"]:
            s.update(safe_stepsize=middle, safe_value=value, safe_grad=grad)
        done = bool(err <= 0.0)
        set_high_mid = bool(dec > 0.0) or bool(value >= s["value_low"])
        set_high_low = bool(slope * (high - low) >= 0.0) and not set_high_mid
        old_low = (low, s["value_low"], s["slope_low"])
        old_high = (high, s["value_high"], s["slope_high"])
        mid = (middle, value, slope)
        new_high = old_low if set_high_low else (
            mid if set_high_mid else old_high)
        new_low = old_low if set_high_mid else mid
        ref = old_high if (set_high_mid or set_high_low) else old_low
        failed = (s["count"] + 1 >= self.max_steps
                  or (too_small and s["safe_stepsize"] > 0.0))
        s.update(low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
                 high=new_high[0], value_high=new_high[1],
                 slope_high=new_high[2], cubic_ref=ref[0],
                 value_cubic_ref=ref[1], done=done,
                 failed=failed and not done, count=s["count"] + 1,
                 stepsize=middle, value=value, grad=grad, slope=slope,
                 decrease_error=dec, curvature_error=curv)

    @staticmethod
    def _safe_step(s):
        """``_try_safe_step``: the last step that decreased the loss
        enough, or none (step 0) when the loss was not finite."""
        if s["safe_stepsize"] > 0.0 or np.isinf(s["decrease_error"]):
            s.update(stepsize=s["safe_stepsize"], value=s["safe_value"],
                     grad=s["safe_grad"])


def _cubicmin(c, a, fa, fpa, b, fb, d, fd):
    """The minimiser of the cubic through (a, fa) with slope fpa, (b, fb)
    and (d, fd) (optax ``_cubicmin``; NaN where it has none)."""
    db, dc = b - a, d - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0, v1 = fb - fa - fpa * db, fd - fa - fpa * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * dc * dc) * v0 + db * db * db * v1) / denom
    radical = B * B - c(3.0) * A * fpa
    return c(a + (-B + np.sqrt(radical)) / (c(3.0) * A))


def _quadmin(c, a, fa, fpa, b, fb):
    """The minimiser of the quadratic through (a, fa) with slope fpa and
    (b, fb) (optax ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return c(a - fpa / (c(2.0) * B))
