"""Optimizer, lr / momentum schedules, gradient accumulation, and EMA.

Counterpart of ``yolo_ad_refine_tpu/train/optim.py`` (reference
engine/trainer.py:753-813 build_optimizer, :209-215 and :369-380 schedules,
:580-588 clip and accumulation, utils/torch_utils.py:511-547 ModelEMA):

- three param groups: ``bias`` (names ending in "bias"), ``nodecay`` (the
  other tensors of ndim <= 1) and ``decay`` (the rest, with weight decay
  ``wd * batch * accumulate / nbs``);
- per-iteration warmup of the lr (the bias group from ``warmup_bias_lr``)
  and of SGD's momentum, then the linear or cosine epoch schedule;
- ``auto`` takes SGD (momentum 0.9) above 10,000 iterations, else Adam with
  lr0 = round(0.002 * 5 / (4 + nc), 6) and b1 = 0.9; both set
  warmup_bias_lr to 0. The JAX package's Adam branch is optax's
  ``add_decayed_weights(wd)`` followed by ``adamw(weight_decay=0)``, i.e.
  coupled L2: here ``torch.optim.Adam(weight_decay=wd)``, not AdamW;
- SGD is Nesterov with the decay added to the gradient;
- gradients of ``accumulate = round(nbs / batch)`` batches are summed; the
  k-th optimizer step clips the summed gradient at global norm 10 (optax's
  rule: scaled by 10 / norm when the norm is not below 10) and uses the
  schedules at batch k * accumulate;
- EMA of params and BN running stats, d = 0.9999 * (1 - exp(-updates / 2000)),
  counted in optimizer steps.

``load_jax_opt_state`` carries the JAX package's optax state into the
torch optimizer for a resume (see its docstring for the map).
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn


# parameters the port holds in another shape than their flax leaf, by the
# leaf's number of dimensions (AdaptiveDynamicTanh alphas: (ns,) in flax,
# (1, ns, 1, 1) here)
FLAX_NDIM = {"alphas": 1}


def param_group_label(name: str, p: torch.Tensor) -> str:
    """The group of one parameter, as ``optim.py:26-34`` labels its flax
    leaf: by the leaf's name and number of dimensions."""
    last = name.split(".")[-1]
    if last.endswith("bias"):
        return "bias"
    return "nodecay" if FLAX_NDIM.get(last, p.ndim) <= 1 else "decay"


def make_lr_fn(lr0: float, lrf: float, epochs: int, nb: int, warmup_epochs: float = 3.0,
               warmup_start: float = 0.0, cos_lr: bool = False):
    """lr at batch ``step``: the epoch factor lf(step // nb) times lr0,
    linearly warmed up from ``warmup_start`` over
    nw = max(round(warmup_epochs * nb), 100) batches."""
    nw = max(round(warmup_epochs * nb), 100) if warmup_epochs > 0 else 0

    def lf(epoch):
        if cos_lr:
            return ((1 - math.cos(epoch * math.pi / epochs)) / 2) * (lrf - 1) + 1
        return (1 - epoch / epochs) * (1.0 - lrf) + lrf

    def lr_fn(step):
        base = lr0 * lf(step // nb)
        if nw == 0 or step >= nw:
            return base
        w = min(max(step / nw, 0.0), 1.0)
        return warmup_start + w * (base - warmup_start)

    return lr_fn


def make_momentum_fn(momentum: float = 0.937, warmup_momentum: float = 0.8,
                     warmup_epochs: float = 3.0, nb: int = 100):
    nw = max(round(warmup_epochs * nb), 100) if warmup_epochs > 0 else 0

    def momentum_fn(step):
        if nw == 0:
            return momentum
        w = min(max(step / nw, 0.0), 1.0)
        return warmup_momentum + w * (momentum - warmup_momentum)

    return momentum_fn


class Optimizer:
    """The torch optimizer with its groups, schedules, clip and gradient
    accumulation. Call ``step()`` after every batch's ``backward()``; it
    steps (and zeroes the gradients) on every ``accumulate``-th batch and
    returns whether it did."""

    def __init__(self, opt: torch.optim.Optimizer, accumulate: int, lr_fns: dict,
                 momentum_fn, grad_clip: float = 10.0):
        self.opt, self.accumulate, self.lr_fns = opt, accumulate, lr_fns
        self.momentum_fn, self.grad_clip = momentum_fn, grad_clip
        self.batches = 0   # batches seen (the JAX TrainState.step)
        self.steps = 0     # optimizer steps taken

    def step(self) -> bool:
        self.batches += 1
        if self.batches % self.accumulate:
            return False
        grads = [p.grad for g in self.opt.param_groups for p in g["params"] if p.grad is not None]
        if grads:
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                         for g in grads]))
            scale = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        at = self.steps * self.accumulate  # the schedules run in batches
        for group in self.opt.param_groups:
            group["lr"] = self.lr_fns[group["name"]](at)
            if "momentum" in group:
                group["momentum"] = self.momentum_fn(at)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.steps += 1
        return True

    def params(self) -> list[torch.Tensor]:
        return [p for g in self.opt.param_groups for p in g["params"]]

    def state_dict(self) -> dict:
        """The torch optimizer's state, the counts, and the gradients summed
        so far towards the next step (None where a parameter has none)."""
        return {"opt": self.opt.state_dict(), "batches": self.batches, "steps": self.steps,
                "acc_grads": [None if p.grad is None else p.grad.detach().clone()
                              for p in self.params()]}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.batches, self.steps = int(state["batches"]), int(state["steps"])
        for p, g in zip(self.params(), state.get("acc_grads") or []):
            p.grad = None if g is None else g.to(p.device, p.dtype)


def build_optimizer(named_params, *, optimizer: str = "auto", lr0: float = 0.01,
                    lrf: float = 0.01, momentum: float = 0.937, weight_decay: float = 0.0005,
                    epochs: int = 100, nb: int = 100, batch: int = 16, nbs: int = 64,
                    warmup_epochs: float = 3.0, warmup_momentum: float = 0.8,
                    warmup_bias_lr: float = 0.1, cos_lr: bool = False, nc: int = 80,
                    grad_clip: float = 10.0):
    """Returns (Optimizer, accumulate, lr_fns), ``lr_fns`` by results.csv
    column (pg0 decay, pg1 nodecay, pg2 bias) at batch steps."""
    if optimizer == "auto":
        warmup_bias_lr = 0.0
        if epochs * nb > 10000:
            optimizer, momentum = "SGD", 0.9
        else:
            optimizer, lr0, momentum = "Adam", round(0.002 * 5 / (4 + nc), 6), 0.9
            lrf = max(lrf, 0.01)
    if optimizer not in ("SGD", "Adam", "AdamW"):
        raise ValueError(f"optimizer must be 'auto', 'SGD' or 'AdamW', got {optimizer!r}")
    accumulate = max(round(nbs / batch), 1)
    wd = weight_decay * batch * accumulate / nbs

    groups = {"bias": [], "nodecay": [], "decay": []}
    for name, p in named_params:
        if p.requires_grad:
            groups[param_group_label(name, p)].append(p)
    starts = {"bias": warmup_bias_lr, "nodecay": 0.0, "decay": 0.0}
    lr_by_group = {k: make_lr_fn(lr0, lrf, epochs, nb, warmup_epochs, starts[k], cos_lr)
                   for k in groups}
    param_groups = [{"params": ps, "name": k, "weight_decay": wd if k == "decay" else 0.0,
                     "lr": lr0} for k, ps in groups.items() if ps]
    if optimizer == "SGD":
        opt = torch.optim.SGD(param_groups, lr=lr0, momentum=momentum, nesterov=True)
    else:  # the JAX package's "AdamW" is coupled L2 (see the module docstring)
        opt = torch.optim.Adam(param_groups, lr=lr0, betas=(momentum, 0.999), eps=1e-8)
    mom_fn = make_momentum_fn(momentum, warmup_momentum, warmup_epochs, nb)
    lr_fns = {"pg0": lr_by_group["decay"], "pg1": lr_by_group["nodecay"],
              "pg2": lr_by_group["bias"]}
    return Optimizer(opt, accumulate, lr_by_group, mom_fn, grad_clip), accumulate, lr_fns


def _last(chain: dict) -> dict:
    """The last transform's state of a serialised optax chain {"0": ..., "1": ...}."""
    return chain[str(max(int(k) for k in chain))]


@torch.no_grad()
def load_jax_opt_state(optimizer: Optimizer, opt_state: dict, model: nn.Module) -> None:
    """Load the JAX package's serialised optax state (``train.msgpack``'s
    ``opt_state``, its train/optim.py build_optimizer tree) into
    ``optimizer``, whose parameters are ``model``'s. From the outside in:
    ``chain(clip_by_global_norm, ...)``; with accumulate > 1,
    ``chain(scale(accumulate), MultiSteps)``, whose ``acc_grads`` hold the
    running mean of ``accumulate`` x the gradients over ``mini_step``
    batches; ``multi_transform`` over the groups bias / nodecay / decay;
    ``inject_hyperparams`` (``count``: optimizer steps); then the optimizer
    last in each group's chain. SGD's ``trace`` is torch SGD's
    ``momentum_buffer`` (both buf = mu * buf + g, dampening 0); Adam's
    ``mu`` / ``nu`` / ``count`` are ``exp_avg`` / ``exp_avg_sq`` / ``step``.
    Each leaf takes its weight's layout change (``jax_to_port``). A
    non-zero ``mini_step`` puts the summed gradients (acc_grads x
    mini_step / accumulate) into ``.grad``, where the port accumulates.
    Raises KeyError or ValueError where the tree does not fit the
    optimizer; nothing is changed then."""
    from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, jax_to_port

    sgd = isinstance(optimizer.opt, torch.optim.SGD)
    top, acc_grads, mini_step = _last(opt_state), None, 0
    if optimizer.accumulate > 1:
        if "mini_step" not in top:
            raise KeyError(f"accumulate {optimizer.accumulate} but the state has no MultiSteps")
        mini_step, acc_grads = int(top["mini_step"]), top["acc_grads"]
        steps = int(top["gradient_step"])
        top = _last(top["inner_opt_state"])
    kinds = ("trace",) if sgd else ("mu", "nu")
    leaves = {k: {} for k in kinds}
    counts, adam_counts = set(), set()
    for label, group in top["inner_states"].items():
        inject = group["inner_state"]
        counts.add(int(inject["count"]))
        inner = _last(inject["inner_state"])["0"]  # the optimizer's chain, its first state
        for k in kinds:
            if k not in inner:
                raise KeyError(f"group {label}: the state holds {sorted(inner)}, not {k} "
                               f"({'SGD' if sgd else 'Adam'} in the port)")
            leaves[k].update(flatten_tree(inner[k]))
        if not sgd:
            adam_counts.add(int(inner["count"]))
    if len(counts) != 1 or len(adam_counts) > 1:
        raise ValueError(f"the groups' step counts differ: {counts} {adam_counts}")
    if optimizer.accumulate == 1:
        steps = counts.pop()
    adam_step = float(adam_counts.pop()) if adam_counts else 0.0
    arrays = {k: jax_to_port(model, v, collections=("params",)) for k, v in leaves.items()}
    grads = (jax_to_port(model, flatten_tree(acc_grads), collections=("params",))
             if mini_step else {})
    named = dict(model.named_parameters())
    ids = {id(p) for p in optimizer.params()}
    if {id(named[n]) for n in arrays[kinds[0]]} != ids:
        raise KeyError("the state's parameters are not the optimizer's")

    def t(a, p):
        return torch.from_numpy(a).to(p.device, p.dtype)

    for name, p in named.items():
        if sgd:
            optimizer.opt.state[p] = {"momentum_buffer": t(arrays["trace"][name], p)}
        else:
            optimizer.opt.state[p] = {"step": torch.tensor(adam_step),
                                      "exp_avg": t(arrays["mu"][name], p),
                                      "exp_avg_sq": t(arrays["nu"][name], p)}
        p.grad = (t(grads[name], p) * (mini_step / optimizer.accumulate)) if mini_step else None
    optimizer.steps = steps


def ema_decay(updates: int, decay: float = 0.9999, tau: float = 2000.0) -> torch.Tensor:
    u = torch.tensor(float(updates), dtype=torch.float32)
    return decay * (1.0 - torch.exp(-u / tau))


class ModelEMA:
    """fp32 exponential moving average of a model's params and BatchNorm
    running stats (its floating-point state); ``ema`` is a model in eval
    mode that validation and checkpoints use."""

    def __init__(self, model: nn.Module, decay: float = 0.9999, tau: float = 2000.0,
                 updates: int = 0):
        self.ema = copy.deepcopy(model).float().eval()
        for p in self.ema.parameters():
            p.requires_grad_(False)
        self.decay, self.tau, self.updates = decay, tau, updates

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        self.updates += 1
        d = ema_decay(self.updates, self.decay, self.tau).item()
        src = model.state_dict()
        for k, e in self.ema.state_dict().items():
            if e.dtype.is_floating_point:
                e.mul_(d).add_(src[k].detach().float() * (1.0 - d))
