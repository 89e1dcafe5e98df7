"""The training optimizer's state in the JAX package's checkpoint layout,
so that a training run resumes from either package's checkpoint
(surf_tpu/runner.py:395-407 saves it, :176-184 and :896-951 restore it).

The JAX runner's optimizer is optax's ``multi_transform`` of two
``adam`` chains, labelled by the parameters' top-level key
(``implicit_surface`` -> ``mlp``, every other key -> ``feat``).  Its state,
as ``jax.tree_util.tree_flatten_with_path`` walks it::

    .inner_states['feat'].inner_state[0].count              Adam's step count
    .inner_states['feat'].inner_state[0].mu<param path>     first moments
    .inner_states['feat'].inner_state[0].nu<param path>     second moments
    .inner_states['feat'].inner_state[1].count              the schedule's count
    .inner_states['mlp']...                                 the same

with ``MaskedNode()`` (no leaves; an empty tuple on disk) in ``mu`` and
``nu`` where a parameter belongs to the other group.  On disk the named
tuples are plain tuples: ``(inner_states,)``, each group
``(((count, mu, nu), (count,)),)``.  ``opt_struct`` is the JAX runner's
``_opt_state_fingerprint``: ``<key path>:<shape>:<dtype>`` of every leaf in
that order, joined by ``|``; dict keys are walked sorted.

The port's ``torch.optim.Adam`` has one group per label: ``mu`` / ``nu``
are each parameter's ``exp_avg`` / ``exp_avg_sq``, Adam's ``count`` its
``step``, and the schedule's ``count`` the ``LambdaLR``'s position.
"""

from __future__ import annotations

import numpy as np
import torch

GROUPS = ("feat", "mlp")        # optax's labels, in its (sorted) order


def group_of(top_key):
    return "mlp" if top_key == "implicit_surface" else "feat"


def leaves_with_path(tree, path=()):
    """(path, leaf) pairs in ``jax.tree_util``'s flatten order (dict keys
    sorted, sequences in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def _keystr(path):
    return "".join(f"[{k!r}]" for k in path)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _group_leaves(params, group):
    return [(p, t) for p, t in leaves_with_path(params) if group_of(p[0]) == group]


def fingerprint(params):
    """The string ``_opt_state_fingerprint`` gives the JAX runner's optimizer
    state for parameters shaped as ``params``."""
    entries = []
    for g in GROUPS:
        pre = f".inner_states[{g!r}].inner_state"
        entries.append(f"{pre}[0].count:():int32")
        for m in ("mu", "nu"):
            entries += [f"{pre}[0].{m}{_keystr(p)}:{tuple(t.shape)}:"
                        f"{str(t.dtype).split('.')[-1]}" for p, t in _group_leaves(params, g)]
        entries.append(f"{pre}[1].count:():int32")
    return "|".join(entries)


def _masked(params, group, fn):
    """``params``' structure with ``fn(tensor)`` on the group's leaves and an
    empty tuple (optax's ``MaskedNode``) on the other group's."""
    def walk(tree, top):
        if isinstance(tree, dict):
            return {k: walk(v, top if top is not None else k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, top) for v in tree]
        return fn(tree) if group_of(top) == group else ()
    return walk(params, None)


def opt_state_tree(params, optimizer, scheduler):
    """The Adam moments, step counts and schedule position as the JAX
    runner saves its ``opt_state`` (numpy leaves)."""
    state = optimizer.state

    def moment(name):
        def fn(t):
            s = state.get(t)
            return np.zeros(tuple(t.shape), np.float32) if not s else \
                s[name].detach().cpu().numpy()
        return fn

    inner = {}
    for g in GROUPS:
        steps = [int(state[t]["step"]) for _, t in _group_leaves(params, g) if state.get(t)]
        count = np.int32(max(steps, default=0))
        adam = (count, _masked(params, g, moment("exp_avg")),
                _masked(params, g, moment("exp_avg_sq")))
        inner[g] = ((adam, (np.int32(scheduler.last_epoch),)),)
    return (inner,)


def _n_leaves(tree):
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_n_leaves(v) for v in tree)
    return 1


def restore_opt_state(params, optimizer, scheduler, tree, saved_struct=None):
    """Load a saved ``opt_state`` (either package's) into ``optimizer`` and
    ``scheduler``.  Refuses, as ``_restore_opt_state`` does, a checkpoint
    whose fingerprint differs from this model's, whose leaf count differs,
    or whose moments have another shape."""
    current = fingerprint(params)
    if saved_struct is not None:
        saved = str(np.asarray(saved_struct))
        if saved != current:
            i = next((j for j, (a, b) in enumerate(zip(saved, current)) if a != b),
                     min(len(saved), len(current)))
            lo = max(0, i - 80)
            raise ValueError(
                "Optimizer state structure changed between save and resume; "
                f"refusing a positional restore. First divergence at char {i}:\n "
                f"saved:   ...{saved[lo:i + 160]}\n current: ...{current[lo:i + 160]}")
    expected = current.count("|") + 1
    if _n_leaves(tree) != expected:
        raise ValueError(f"Optimizer state leaf count mismatch: checkpoint has "
                         f"{_n_leaves(tree)}, current optimizer expects {expected}")
    (inner,) = tree
    positions = set()
    for g in GROUPS:
        ((adam, sched),) = inner[g]
        count, mu, nu = adam
        positions.add(int(np.asarray(sched[0])))
        for p, t in _group_leaves(params, g):
            moments = {}
            for name, src in (("exp_avg", mu), ("exp_avg_sq", nu)):
                a = np.asarray(_get(src, p))
                if a.shape != tuple(t.shape):
                    raise ValueError(f"Optimizer state leaf {g} {name}{_keystr(p)} shape "
                                     f"mismatch: checkpoint {a.shape} vs expected "
                                     f"{tuple(t.shape)}")
                moments[name] = torch.tensor(a, dtype=t.dtype, device=t.device)
            optimizer.state[t] = {"step": torch.tensor(float(np.asarray(count)),
                                                       dtype=torch.float32), **moments}
    if len(positions) != 1:
        raise ValueError(f"the two groups' schedules are at different steps {positions}")
    set_schedule_position(scheduler, positions.pop())


def set_schedule_position(scheduler, position):
    """Put a ``LambdaLR`` at ``position`` steps, each group at the learning
    rate that step gives."""
    scheduler.last_epoch = position
    lrs = [base * lam(position) for base, lam in zip(scheduler.base_lrs,
                                                     scheduler.lr_lambdas)]
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs
