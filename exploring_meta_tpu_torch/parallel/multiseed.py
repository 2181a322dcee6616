"""All seeds of a sweep training as one program (port of
``exploring_meta_tpu/parallel/multiseed.py``).

JAX runs a seed sweep as ``jit(vmap(train))`` over stacked per-seed state.
The port writes the seed axis out instead, as it writes out the task axis
(``adapt/maml.py:per_task``): per-seed params are stacked ``[S, ...]``
leaf tensors, and below the outer step the seed axis folds into the task
axis, seed-major: :func:`seeded` turns ``[S, ...]`` into per-task ``[S·B,
...]`` copies, so every kernel of an iteration runs once for all seeds
(the CNN4 kernels at ``S·B`` tasks, the sweeps over ``S·B`` tasks' lanes).
Only the outer step and the metrics see ``S``: the loss is the sum over
seeds of each seed's mean task loss, whose gradient with respect to seed
``s``'s params is that seed's own, and every metric is ``[S]``.

Every random draw of a seeded iteration is made per seed, from that
seed's ``torch.Generator``, in the order and shape a solo run of that seed
draws it, and concatenated on the task axis (:func:`seed_draws`;
``models/distributions.py:normal_sample`` for the action noise). Row ``i``
of a seeded run is therefore a solo run of seed ``i``, up to the rounding
of batched arithmetic at another batch size.

The builders are ``adapt/maml.py:make_train_scan(..., seeds=S)`` (vision)
and ``rl/train_scan.py:make_seeded_{trpo,adam}_train_scan``; the sweep
command is ``sweep.py --vmap_seeds``. With ``--mesh N`` (JAX shards the
seed axis over the mesh) the seeds split into N contiguous groups
(:func:`seed_groups`), one program a rank; seeds are independent, so the
ranks run no collectives.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from exploring_meta_tpu_torch.utils.tree import tree_map


def stack_seed_states(init_fn: Callable, seeds: Sequence[int], device,
                      outer_lr: float | None = None):
    """Per-seed initial training state, stacked on a leading seed axis.

    Each seed's state is derived as a solo trainer run derives it
    (``trainers/rl.py``, ``trainers/vision.py``): ``gen =
    torch.Generator(device).manual_seed(seed)``, then ``init_fn(gen)``.
    With ``outer_lr`` the stacked leaves require grad and one
    ``adapt/maml.py:adam`` steps them: Adam is elementwise and every seed
    steps together, so it is S Adams.

    -> ``(params [S, ...], adam | None, gens)``, ``gens`` a tuple of one
    generator per seed, each where its solo run's stands after init."""
    gens, per_seed = [], []
    for s in seeds:
        gen = torch.Generator(device=device).manual_seed(int(s))
        per_seed.append(init_fn(gen))
        gens.append(gen)
    params = tree_map(lambda *xs: torch.stack(xs), *per_seed)
    opt = None
    if outer_lr is not None:
        from exploring_meta_tpu_torch.adapt.maml import adam
        params = tree_map(torch.Tensor.requires_grad_, params)
        opt = adam(params, outer_lr)
    return params, opt, tuple(gens)


def seeded(params, B: int):
    """Per-seed ``[S, ...]`` params -> ``[S·B, ...]`` per-task copies,
    seed-major (rows ``s·B .. s·B + B - 1`` are seed ``s``'s): the
    counterpart of ``per_task`` for stacked params. Differentiable: the
    gradient of each copy flows back to its seed's row."""
    return tree_map(lambda t: t.repeat_interleave(B, dim=0), params)


def seed_params(params, i: int):
    """Seed ``i``'s params out of a stacked tree, detached."""
    return tree_map(lambda t: t[i].detach(), params)


def seed_means(x: torch.Tensor, seeds: int | None) -> torch.Tensor:
    """Mean over the task axis: a scalar for a solo run (``seeds=None``),
    ``[S]`` per-seed means of seed-major ``[S·B, ...]`` values."""
    if seeds is None:
        return x.mean()
    return x.reshape(seeds, -1).mean(dim=1)


def seed_draws(draw: Callable, gen, seeds: int | None = None):
    """``draw(gen)`` for a solo run; for ``seeds`` seeds ``gen`` is the
    tuple of their generators, each draws its own share, and the shares
    are concatenated seed-major on the leading (task) axis, field by field
    where ``draw`` returns a tuple."""
    if seeds is None:
        return draw(gen)
    outs = [draw(g) for g in gen]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(xs) for xs in zip(*outs))
    return torch.cat(outs)


def seed_groups(seeds: Sequence[int], n: int) -> list:
    """``seeds`` as ``n`` contiguous equal groups, one a rank of a
    ``--mesh n`` sweep; a seed count the mesh does not divide raises JAX's
    ``vmap_seeds`` message."""
    if len(seeds) % n:
        raise ValueError(
            f"{len(seeds)} seeds cannot shard evenly over the {n}-device "
            f"mesh — use a seed count that is a multiple of the mesh size "
            f"(pad with extra seeds)")
    k = len(seeds) // n
    return [list(seeds[i * k:(i + 1) * k]) for i in range(n)]
