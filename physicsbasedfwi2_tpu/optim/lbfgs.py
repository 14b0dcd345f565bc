"""L-BFGS with Wolfe line search.

Capability-equivalent of the reference's vendored PyTorch-LBFGS
(functions/LBFGS.py:9-1072: two-loop recursion, Powell damping,
cubic-interpolation Armijo/Wolfe line searches, FullBatchLBFGS
closure API) used by the AutoElMar22LBFGS workload
(AutoElMar22LBFGS_model.py:128-137).

Design: we build on ``optax.lbfgs`` (two-loop recursion +
zoom linesearch, fully jittable — every line-search probe is a
compiled forward, not an MPI/DENISE subprocess like the reference's,
and `optax.value_and_grad_from_state` reuses the accepted probe's
value/grad so no propagator call is wasted).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import optax


class LbfgsState(NamedTuple):
    params: Any
    opt_state: Any


def lbfgs_wolfe(learning_rate: float | None = None, *,
                memory_size: int = 10,
                max_linesearch_steps: int = 20) -> optax.GradientTransformation:
    """optax L-BFGS with strong-Wolfe zoom linesearch.

    memory_size=10 matches the reference config
    (AutoElMar22LBFGS_model.py:135-137: history_size=10,
    line_search='Wolfe').
    """
    return optax.lbfgs(
        learning_rate,
        memory_size=memory_size,
        linesearch=optax.scale_by_zoom_linesearch(
            max_linesearch_steps=max_linesearch_steps,
            initial_guess_strategy="one"),
    )


def make_lbfgs_step(loss_fn: Callable, opt: optax.GradientTransformation):
    """Jittable closure-style step: (params, opt_state) ->
    (params, opt_state, loss).

    ``loss_fn(params) -> scalar`` is the full-batch objective (the
    reference's ``closure``, AutoElMar22_model.py:484-508).  Cached
    value/grad from the linesearch are reused via
    ``optax.value_and_grad_from_state`` — the "don't waste propagator
    calls" design point from SURVEY.md §7."""

    value_and_grad = optax.value_and_grad_from_state(loss_fn)

    @jax.jit
    def step(params, opt_state):
        value, grad = value_and_grad(params, state=opt_state)
        updates, opt_state = opt.update(
            grad, opt_state, params, value=value, grad=grad,
            value_fn=loss_fn)
        params = optax.apply_updates(params, updates)
        return params, opt_state, value

    return step


def run_lbfgs(loss_fn: Callable, params, *, steps: int,
              memory_size: int = 10, learning_rate: float | None = None):
    """Convenience driver: run L-BFGS for ``steps`` iterations,
    returning (params, losses)."""
    opt = lbfgs_wolfe(learning_rate, memory_size=memory_size)
    opt_state = opt.init(params)
    step = make_lbfgs_step(loss_fn, opt)
    losses = []
    for _ in range(steps):
        params, opt_state, value = step(params, opt_state)
        losses.append(float(value))
    return params, losses
