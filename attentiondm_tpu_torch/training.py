"""DDPM training: the optimizers, the train state and the train step (port
of `attentiondm_tpu/training.py`).

The three optimizers are optax's update rules, written as functions on the
param tree's leaves (`torch._foreach_*`), with states shaped as optax's
tuples so that a training state saves under JAX's checkpoint keys
(`checkpoint.save_checkpoint`) and loads in either package:
- Adam = `optax.adamw(lr, b1=beta1, b2=0.999, eps, weight_decay)`: bias-corrected
  m / (sqrt(v) + eps), plus the decoupled decay on the old params, times -lr;
  state (ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState());
- RMSProp = `add_decayed_weights(weight_decay)` then `optax.rmsprop(lr)`:
  g * rsqrt(nu + 1e-8) with nu = 0.1 g^2 + 0.9 nu from 0, times -lr (not
  `torch.optim.RMSprop`, whose alpha is 0.99 and whose eps is outside the
  root); state (EmptyState(), (ScaleByRmsState(nu), EmptyState(), EmptyState()));
- SGD = `optax.sgd(lr, momentum=0.9)`: the trace t = g + 0.9 t, times -lr;
  state (TraceState(trace), EmptyState()).

The step (`make_train_step`): eps-MSE at antithetic timesteps, gradients by
autograd over the param tree, clipping by the global norm as JAX clips
(scale = min(1, clip / (norm + 1e-12))), the optimizer update, then the EMA
of the new params.  Forward and backward run under `exact_f32()`, so that
cuDNN's TF32 does not take the float32 convolutions on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from .diffusion.losses import noise_estimation_loss
from .models.ema import ema_init, ema_update
from .models.unet import UNetConfig, dropout_shapes, map_tree, tree_leaves, tree_unflatten, unet_apply
from .ops.precision import exact_f32


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32, 0-d
    mu: Any
    nu: Any


class ScaleByRmsState(NamedTuple):
    nu: Any


class TraceState(NamedTuple):
    trace: Any


class GradientTransformation(NamedTuple):
    """optax's pair: `init(params) -> state`, `update(grads, state, params) -> (updates, state)`."""
    init: Callable
    update: Callable


def _zeros(params):
    return map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _scaled_sum(a, x, b, y):
    """[a * xi + b * yi] over the lists x and y (two products, then their sum)."""
    out = torch._foreach_mul(x, a)
    torch._foreach_add_(out, torch._foreach_mul(y, b))
    return out


def _add_decay(g, p, weight_decay: float):
    """g + wd * p (add_decayed_weights); at wd = 0 the sum is g itself, bit for bit."""
    return torch._foreach_add(g, torch._foreach_mul(p, weight_decay)) if weight_decay else g


def _count_inc(count):
    """optax's safe_increment of an int32 count."""
    return torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> GradientTransformation:
    def init(params):
        first = tree_leaves(params)[0]
        return (ScaleByAdamState(torch.zeros((), dtype=torch.int32, device=first.device), _zeros(params),
                                 _zeros(params)), EmptyState(), EmptyState())

    def update(grads, state, params):
        adam = state[0]
        g, p = tree_leaves(grads), tree_leaves(params)
        mu = _scaled_sum(1.0 - b1, g, b1, tree_leaves(adam.mu))
        nu = _scaled_sum(1.0 - b2, torch._foreach_mul(g, g), b2, tree_leaves(adam.nu))
        count = _count_inc(adam.count)
        bc1, bc2 = 1.0 - torch.pow(b1, count), 1.0 - torch.pow(b2, count)  # float32, on the device
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        u = torch._foreach_mul(_add_decay(u, p, weight_decay), -lr)
        new = ScaleByAdamState(count, tree_unflatten(params, mu), tree_unflatten(params, nu))
        return tree_unflatten(params, u), (new, EmptyState(), EmptyState())

    return GradientTransformation(init, update)


def rmsprop(lr: float, weight_decay: float = 0.0, decay: float = 0.9, eps: float = 1e-8) -> GradientTransformation:
    """`optax.chain(add_decayed_weights(weight_decay), optax.rmsprop(lr))` at optax's defaults."""
    def init(params):
        return (EmptyState(), (ScaleByRmsState(_zeros(params)), EmptyState(), EmptyState()))

    def update(grads, state, params):
        g = _add_decay(tree_leaves(grads), tree_leaves(params), weight_decay)
        nu = _scaled_sum(1.0 - decay, torch._foreach_mul(g, g), decay, tree_leaves(state[1][0].nu))
        u = torch._foreach_mul(torch._foreach_rsqrt(torch._foreach_add(nu, eps)), g)
        u = torch._foreach_mul(u, -lr)
        return tree_unflatten(params, u), (EmptyState(), (ScaleByRmsState(tree_unflatten(params, nu)), EmptyState(),
                                                          EmptyState()))

    return GradientTransformation(init, update)


def sgd(lr: float, momentum: float = 0.9) -> GradientTransformation:
    """`optax.sgd(lr, momentum)`: a trace t = g + momentum * t."""
    def init(params):
        return (TraceState(_zeros(params)), EmptyState())

    def update(grads, state, params):
        t = torch._foreach_add(tree_leaves(grads), torch._foreach_mul(tree_leaves(state[0].trace), momentum))
        return tree_unflatten(params, torch._foreach_mul(t, -lr)), (TraceState(tree_unflatten(params, t)),
                                                                    EmptyState())

    return GradientTransformation(init, update)


def get_optimizer(config) -> GradientTransformation:
    """Adam / RMSProp / SGD per the config's optim group, as JAX builds them."""
    o = config.optim
    if o.optimizer == "Adam":
        return adamw(o.lr, b1=o.beta1, b2=0.999, eps=o.eps, weight_decay=o.weight_decay if o.weight_decay else 0.0)
    if o.optimizer == "RMSProp":
        return rmsprop(o.lr, weight_decay=o.weight_decay or 0.0)
    if o.optimizer == "SGD":
        return sgd(o.lr, momentum=0.9)
    raise NotImplementedError(f"Optimizer {o.optimizer} not understood.")


@torch.no_grad()
def apply_updates(params, updates):
    """p + u for every leaf."""
    return tree_unflatten(params, torch._foreach_add(tree_leaves(params), tree_leaves(updates)))


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    ema: Any
    step: torch.Tensor  # int32, 0-d


def init_train_state(params, tx: GradientTransformation, use_ema: bool = True) -> TrainState:
    first = tree_leaves(params)[0]
    return TrainState(params=params, opt_state=tx.init(params), ema=ema_init(params) if use_ema else None,
                      step=torch.zeros((), dtype=torch.int32, device=first.device))


def antithetic_timesteps(generator, n: int, num_timesteps: int, *, base=None):
    """t ~ U[0, T) for n // 2 + 1 draws (from `generator` on its device, or
    `base` handed in), mirrored as T - t - 1, the first n kept."""
    if base is None:
        base = torch.randint(0, num_timesteps, (n // 2 + 1,), generator=generator, device=generator.device)
    return torch.cat([base, num_timesteps - base - 1])[:n]


@torch.no_grad()
def global_norm(tree):
    """sqrt of the sum of every leaf's squares (optax.global_norm)."""
    return torch.sqrt(torch.stack([torch.sum(g * g) for g in tree_leaves(tree)]).sum())


@torch.no_grad()
def clip_by_global_norm(grads, clip: float, sum_squares: Callable | None = None):
    """(grads * min(1, clip / (norm + 1e-12)), norm): JAX's rule (not
    `clip_grad_norm_`, whose 1e-6 differs).  `sum_squares(grads)` gives the
    norm's square where some leaves are shards (`make_sharded_train_step`)."""
    norm = global_norm(grads) if sum_squares is None else torch.sqrt(sum_squares(grads))
    scale = torch.clamp(torch.full_like(norm, clip) / (norm + 1e-12), max=1.0)  # a true division, as JAX divides
    return tree_unflatten(grads, torch._foreach_mul(tree_leaves(grads), scale)), norm


def loss_and_grads(apply, params, x0, t, e, betas, randomness: dict, n: int | None = None):
    """(the batch's eps-MSE, detached; its gradient tree over `params`):
    `apply(params, x, t, **randomness)` is the model, run forward and
    backward under `exact_f32()`.  With `n`, the loss is the batch's sum
    over `n` (a rank's share of a global batch of n)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    with exact_f32(), torch.enable_grad():
        se, _ = noise_estimation_loss(lambda x, tt: apply(live, x, tt, **randomness), x0, t, e, betas,
                                      keepdim=n is not None)
        loss = se if n is None else se.sum() / n
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


@dataclasses.dataclass
class StepSharding:
    """How `make_train_step` runs on one rank of a mesh (built by
    `make_sharded_train_step`): `local(x0, t, e, masks)` cuts the global
    batch and its draws to this rank's slices; `reduce(x)` sums a gradient
    or the loss over the ranks that share it; `sum_squares` (or None) is
    clipping's squared norm over sharded leaves; `parallel` the forward's
    `unet_apply(parallel=)` context (or None)."""
    local: Callable
    reduce: Callable
    sum_squares: Callable | None
    parallel: Any


def make_train_step(cfg: UNetConfig, betas: torch.Tensor, tx: GradientTransformation, *,
                    grad_clip: float | None = 1.0, ema_rate: float | None = 0.9999,
                    model_apply: Callable | None = None, sharding: StepSharding | None = None):
    """The training step `(state, x0 [N, H, W, C], *, generator=None, t=None,
    e=None, dropout_masks=None) -> (state, loss)`.  The timesteps, the noise
    and the dropout masks are drawn from `generator` (a torch.Generator on
    x0's device, in that order), or handed in (`t` [N] int, `e` like x0,
    `dropout_masks` as `unet_apply` takes them).  `model_apply(params, x,
    t, **randomness)` replaces the UNet's train-mode forward; the loss is
    left on the device.  `sharding` runs the step on one rank of a mesh
    (`make_sharded_train_step`): x0 and the draws are the global batch's,
    the masks drawn whole before the forward, each cut to the rank's slice."""
    num_timesteps = betas.shape[0]
    par = None if sharding is None else sharding.parallel
    apply = model_apply or (lambda p, x, tt, **rnd: unet_apply(p, cfg, x, tt, train=True, parallel=par, **rnd))

    def train_step(state: TrainState, x0, *, generator=None, t=None, e=None, dropout_masks=None):
        if generator is None and (t is None or e is None):
            raise ValueError("train_step draws t and e from generator= (a torch.Generator), or takes t= and e=")
        n = x0.shape[0]
        if t is None:
            t = antithetic_timesteps(generator, n, num_timesteps)
        if e is None:
            e = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        if sharding is None:
            rnd = {"dropout_masks": dropout_masks} if dropout_masks is not None else {"generator": generator}
            loss, grads = loss_and_grads(apply, state.params, x0, t, e, betas, rnd)
        else:
            if dropout_masks is None and generator is not None:
                dropout_masks = _draw_masks(cfg, n, generator, x0.device)
            xl, tl, el, masks = sharding.local(x0, t, e, dropout_masks)
            loss, grads = loss_and_grads(apply, state.params, xl, tl, el, betas, {"dropout_masks": masks}, n=n)
            loss, grads = sharding.reduce(loss), map_tree(sharding.reduce, grads)
        if grad_clip is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip, None if sharding is None else sharding.sum_squares)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state, state.params)
            params = apply_updates(state.params, updates)
            ema = (ema_update(state.ema, params, mu=ema_rate) if state.ema is not None and ema_rate is not None
                   else state.ema)
        return TrainState(params=params, opt_state=opt_state, ema=ema, step=state.step + 1), loss

    return train_step


def map_train_state(fn, state: TrainState) -> TrainState:
    """The state with `fn` applied to every param-shaped tree: the params,
    the EMA and the optimizer's moments or trace (its counts stay)."""
    def opt(node):
        if isinstance(node, dict):
            return fn(node)
        if isinstance(node, tuple):
            vals = [opt(v) for v in node]
            return type(node)(*vals) if hasattr(node, "_fields") else tuple(vals)
        return node

    return TrainState(params=fn(state.params), opt_state=opt(state.opt_state),
                      ema=None if state.ema is None else fn(state.ema), step=state.step)


def _draw_masks(cfg: UNetConfig, n: int, generator, device):
    """The dropout masks of a batch of `n` drawn from `generator` in
    `unet_apply`'s order and shapes, as its train-mode forward draws them
    (none where dropout does not run)."""
    if not cfg.dropout > 0:
        return None
    keep = 1.0 - cfg.dropout
    return [torch.rand(shape, generator=generator, device=device) < keep for shape in dropout_shapes(cfg, n)]


def make_sharded_train_step(mesh, cfg: UNetConfig, betas: torch.Tensor, tx: GradientTransformation, *,
                            param_specs=None, spatial: bool = False, grad_clip: float | None = 1.0,
                            ema_rate: float | None = 0.9999):
    """`make_train_step` over `mesh` (a `parallel.Mesh`): the step
    `(state, x0 [global N, H, W, C], *, generator=None, t=None, e=None,
    dropout_masks=None) -> (state, loss)`, run by every rank of the mesh.

    Every rank draws the whole global batch's t, eps and dropout masks (or
    takes them whole) and keeps its own slice, so the step equals the
    one-device step up to the collectives' summation order.
    - param_specs=None, spatial=False: data parallel.  The batch splits
      over `data`; each rank's gradient of its share of the global mean is
      all-reduced over `data`.
    - param_specs (from `parallel.unet_param_specs`): data x tensor
      parallel.  `state` holds this rank's shards (`shard_unet_params`, and
      the optimizer state and EMA made from them), which stay on the spec
      through each update; the forward's collectives are Megatron's
      (`parallel.tp`); the gradients all-reduce over `data`, and clipping
      sums the sharded leaves' squares over `model`.
    - spatial=True: data x spatial parallel.  The batch splits over `data`
      and the image height over `model` (the levels `parallel.sp_levels`
      replicates run whole on every rank, their dropout masks too); params
      stay whole, and every rank's gradient of its rows' share of the loss
      all-reduces over the mesh.
    `spatial` with `param_specs` raises ValueError: both shard the model axis."""
    from .parallel.collectives import all_reduce
    from .parallel.mesh import local_slice
    from .parallel.tp import UNetParallel

    if spatial and param_specs is not None:
        raise ValueError("spatial sharding shards activations; tensor parallelism shards the same mesh axis — pick one")
    kw = dict(grad_clip=grad_clip, ema_rate=ema_rate)
    if mesh.size == 1:
        return make_train_step(cfg, betas, tx, **kw)
    mode = "tp" if param_specs is not None else "sp" if spatial else None
    par = None if mode is None else UNetParallel.of(mesh, mode)
    model_g = mesh.groups.get("model")
    groups = [g for g in (mesh.groups.get("data"), model_g if spatial else None) if g is not None]
    mask_dim = None if par is None else 3 if par.tp else 1  # tp splits the masks' channels, sp their rows
    row_dim = 1 if par is not None and par.sp else None
    # sp: the heights of the split levels; a mask of a level run whole stays whole
    split = {cfg.resolution >> i for i in range(par.check_rows(cfg))} if row_dim else set()

    def cut(x, dim_model=None):
        x = local_slice(x, mesh, "data", 0)
        return x if dim_model is None else local_slice(x, mesh, "model", dim_model)

    def local(x0, t, e, masks):
        masks = None if masks is None else [cut(mk, None if row_dim and mk.shape[1] not in split else mask_dim)
                                            for mk in masks]
        return cut(x0, row_dim), cut(t), cut(e, row_dim), masks

    def reduce(x):
        for g in groups:
            x = all_reduce(x, g)
        return x

    sum_squares = None
    if par is not None and par.tp:
        specs = tree_leaves(param_specs)

        def sum_squares(grads):
            """The replicated leaves' squares once, the shards' summed over the model ranks."""
            sq = [torch.sum(x * x) for x in tree_leaves(grads)]
            rep = torch.stack([q for q, sp in zip(sq, specs) if sp is None]).sum()
            return rep + all_reduce(torch.stack([q for q, sp in zip(sq, specs) if sp is not None]).sum(), model_g)

    return make_train_step(cfg, betas, tx, sharding=StepSharding(local, reduce, sum_squares, par), **kw)


# a train step on the card against the same step on the CPU (or a port step against JAX's): Adam's first update
# is about lr * sign(g), so an element whose gradient lies within rounding of 0 may step the other way.  The
# tolerances are the CPU tests' (tests/test_torch_training.py): params and EMA within PARAM_REL of their tree's
# largest magnitude on at least SHARE of the elements and within 2 * lr * steps everywhere; each moment or trace
# within MOMENT_REL of its own largest magnitude on SHARE; counts and steps equal
PARAM_REL, MOMENT_REL, SHARE = 1e-6, 1e-5, 0.999


def _off_share(got, want, rel):
    """(share of elements off by more than rel x want's largest magnitude, the largest difference) over two trees."""
    pairs = [(g.detach().cpu().double(), w.detach().cpu().double()) for g, w in zip(tree_leaves(got),
                                                                                    tree_leaves(want))]
    scale = max(float(w.abs().max()) for _, w in pairs if w.numel()) or 1.0
    n = sum(w.numel() for _, w in pairs)
    off = sum(int(((g - w).abs() > rel * scale).sum()) for g, w in pairs)
    worst = max(float((g - w).abs().max()) for g, w in pairs if w.numel())
    return off / n, worst


def _moment_trees(opt_state, path="opt_state"):
    """(path, subtree) of every param-shaped tree (mu, nu, trace) and 0-d leaf (count) of an optimizer state."""
    if isinstance(opt_state, tuple):
        for i, v in enumerate(opt_state):
            yield from _moment_trees(v, f"{path}/{i}")
    else:
        yield path, opt_state


def compare_train_states(got: TrainState, want: TrainState, lr: float, steps: int = 1) -> dict:
    """Two training states after the same `steps` steps, held at the
    tolerances above: {tree: (share off, largest difference)} and "ok"."""
    out = {"params": _off_share(got.params, want.params, PARAM_REL)}
    ok = out["params"][0] <= 1 - SHARE and out["params"][1] <= 2 * lr * steps
    if want.ema is not None:
        out["ema"] = _off_share(got.ema, want.ema, PARAM_REL)
        ok &= out["ema"][0] <= 1 - SHARE and out["ema"][1] <= 2 * lr * steps
    moments = dict(_moment_trees(want.opt_state))
    for path, (_, g) in zip(moments, _moment_trees(got.opt_state)):
        if torch.is_tensor(moments[path]):
            ok &= int(g) == int(moments[path])
        else:
            out[path] = _off_share(g, moments[path], MOMENT_REL)
            ok &= out[path][0] <= 1 - SHARE
    out["ok"] = bool(ok and int(got.step) == int(want.step))
    return out
