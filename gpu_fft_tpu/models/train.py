"""Training-step builders for the model family.

Functional, optax-based, and mesh-aware: ``make_train_step`` is the
single-chip jitted step; ``make_data_parallel_step`` is the same step as
one ``shard_map`` over a named mesh axis — batch sharded, parameters
replicated, gradients averaged with a single ``pmean`` collective.
The spectral transforms inside the model stay shard-local (each device
transforms only its own batch rows), so the only collective per step is
the gradient reduction — the canonical dp layout from the scaling-book
recipe, not a translation of any host-side loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

__all__ = [
    "mse",
    "make_train_step",
    "make_data_parallel_step",
    "make_gspmd_step",
    "param_shardings",
    "fit",
]


def mse(pred, target):
    """Mean-squared error over all axes."""
    return jnp.mean((pred - target) ** 2)


def _last_axis_shards(shape, size) -> bool:
    """The single layout rule shared by params and optimizer state: an
    array shards its LAST axis over the mesh axis iff that axis is
    divisible by (and at least) the axis size."""
    return bool(shape) and shape[-1] % size == 0 and shape[-1] >= size


def _check_batch_divisible(x, size, axis_name):
    if x.shape[0] % size:
        raise ValueError(
            f"batch dimension {x.shape[0]} must be divisible by mesh axis "
            f"{axis_name!r} (size {size}) — pad or rebatch the data"
        )


def make_train_step(apply_fn, optimizer, loss_fn=mse):
    """Jitted ``(params, opt_state, x, y) -> (params, opt_state, loss)``.

    ``apply_fn(params, x)`` is the model forward (e.g. a bound
    ``model.apply`` with variables as the first argument).
    """

    @jax.jit
    def step(params, opt_state, x, y):
        def loss(p):
            return loss_fn(apply_fn(p, x), y)

        value, grads = jax.value_and_grad(loss)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, value

    return step


def make_data_parallel_step(apply_fn, optimizer, mesh, axis="dp", loss_fn=mse):
    """Data-parallel train step over ``mesh``'s ``axis``.

    Batch rows shard over ``axis``; parameters and optimizer state are
    replicated.  Each device computes its local loss/grad (all spectral
    transforms batch-local — zero collectives in the forward/backward),
    then one ``pmean`` averages gradients and loss across the axis.
    Updates are computed post-reduction so every replica applies the
    identical step: parameters stay bitwise-replicated without any
    re-broadcast.

    The leading batch dimension of ``x``/``y`` must be divisible by the
    mesh axis size (shard_map splits it evenly); the step checks and
    raises a clear ValueError otherwise.
    """
    size = mesh.shape[axis]

    def local(params, opt_state, x, y):
        def loss(p):
            return loss_fn(apply_fn(p, x), y)

        value, grads = jax.value_and_grad(loss)(params)
        value = jax.lax.pmean(value, axis)
        grads = jax.lax.pmean(grads, axis)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, value

    sharded = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    jitted = jax.jit(sharded)

    def step(params, opt_state, x, y):
        _check_batch_divisible(x, size, axis)
        return jitted(params, opt_state, x, y)

    return step


def param_shardings(params, mesh, axis="tp"):
    """Channel-sharded NamedShardings for a parameter pytree.

    The tensor-parallel layout rule: each array shards its LAST axis over
    ``axis`` when divisible by the axis size (Dense kernels and biases
    split their output features; spectral-conv weights split their kept
    modes), otherwise it stays replicated.  This is a layout HINT, not a
    program transform — under ``jit`` GSPMD propagates the shardings
    through the whole step and inserts the collectives itself, so
    correctness never depends on the rule and a bad hint costs only
    performance (the scaling-book recipe: pick a mesh, annotate, let XLA
    place the comms).
    """
    from jax.sharding import NamedSharding

    size = mesh.shape[axis]

    def rule(p):
        spec = [None] * p.ndim
        if _last_axis_shards(p.shape, size):
            spec[-1] = axis
        return NamedSharding(mesh, P(*spec))

    return jax.tree.map(rule, params)


def make_gspmd_step(apply_fn, optimizer, mesh, dp_axis=None, tp_axis=None, loss_fn=mse):
    """2-D-parallel train step via jit + sharding annotations (GSPMD).

    Batch rows shard over ``dp_axis``; parameters (and the mirrored optax
    state) shard channels over ``tp_axis`` per :func:`param_shardings`.
    Unlike :func:`make_data_parallel_step` (explicit shard_map + pmean),
    this is the compiler-placed form: one ``jit`` with in/out shardings,
    XLA inserts every collective.  Either axis may be ``None`` to run
    1-D dp-only or tp-only.  Returns ``(step, shard_params)`` where
    ``shard_params(params, opt_state)`` places an existing (replicated)
    state onto the mesh layout.
    """
    from jax.sharding import NamedSharding

    def shardings_of(params, opt_state):
        if tp_axis is not None:
            p_sh = param_shardings(params, mesh, tp_axis)
        else:
            rep = NamedSharding(mesh, P())
            p_sh = jax.tree.map(lambda _: rep, params)
        # optax state mirrors the param tree where it holds arrays of the
        # same shape (mu/nu); scalars (count) replicate.  Same predicate
        # as param_shardings so the mirrored layout cannot drift.
        def opt_rule(s):
            if tp_axis is not None and _last_axis_shards(s.shape, mesh.shape[tp_axis]):
                return NamedSharding(mesh, P(*([None] * (s.ndim - 1) + [tp_axis])))
            return NamedSharding(mesh, P())

        o_sh = jax.tree.map(opt_rule, opt_state)
        return p_sh, o_sh

    data_spec = P(dp_axis) if dp_axis is not None else P()
    data_sh = jax.sharding.NamedSharding(mesh, data_spec)

    def step_impl(params, opt_state, x, y):
        def loss(p):
            return loss_fn(apply_fn(p, x), y)

        value, grads = jax.value_and_grad(loss)(params)
        updates, new_opt = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_opt, value

    cache = {}

    def _tree_key(tree):
        leaves, structure = jax.tree.flatten(tree)
        return (structure, tuple(getattr(l, "shape", ()) for l in leaves))

    def step(params, opt_state, x, y):
        # The sharding layout needs the param tree, which only exists at
        # call time — build the jitted step on first use.  The cache is
        # keyed on the (structure, shapes) of both trees, so calling the
        # same returned step with a different model/optimizer state builds
        # fresh shardings instead of silently reusing stale layout hints.
        if dp_axis is not None:
            _check_batch_divisible(x, mesh.shape[dp_axis], dp_axis)
        key = (_tree_key(params), _tree_key(opt_state))
        if key not in cache:
            p_sh, o_sh = shardings_of(params, opt_state)
            cache[key] = jax.jit(
                step_impl,
                in_shardings=(p_sh, o_sh, data_sh, data_sh),
                out_shardings=(p_sh, o_sh, None),
            )
        return cache[key](params, opt_state, x, y)

    def shard_params(params, opt_state):
        p_sh, o_sh = shardings_of(params, opt_state)
        return (
            jax.tree.map(jax.device_put, params, p_sh),
            jax.tree.map(jax.device_put, opt_state, o_sh),
        )

    return step, shard_params


def fit(step, params, opt_state, data, steps):
    """Run ``steps`` updates cycling over ``data`` (a list of (x, y)).

    Returns ``(params, opt_state, losses)`` with per-step host floats —
    a convenience loop for examples/tests, not a production harness.
    """
    losses = []
    for i in range(steps):
        x, y = data[i % len(data)]
        params, opt_state, value = step(params, opt_state, x, y)
        losses.append(float(value))
    return params, opt_state, losses
