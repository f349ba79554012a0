"""The trainers' optimizer: optax's chain(clip_by_global_norm, adam) with
its learning-rate schedules, update for update.

Adam is element-wise and the global norm sums every element, so running it
on the port's tensors (transposed or gate-packed flax leaves) gives flax's
update of each leaf. Hazards, each as optax 0.2 has it:
  * clip_by_global_norm(c) leaves the gradients as they are when
    ||g|| < c and otherwise scales them by c / ||g|| (computed as
    (g / ||g||) * c); torch.nn.utils.clip_grad_norm_ divides by
    ||g|| + 1e-6, and is not used;
  * adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, bias
    corrected by 1 - b^count after the count is incremented, update
    mu_hat / (sqrt(nu_hat) + eps) with eps = 1e-8 outside the root;
  * the schedule is read at the update count BEFORE its increment, so a
    warmup from 0 makes the first update's learning rate 0.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule, in float32."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        c = np.float32(min(count, decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * c / np.float32(decay_steps)))
        return float(np.float32(init_value) * (
            np.float32(1 - alpha) * cosine + np.float32(alpha)))
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then cosine decay to end_value at
    decay_steps (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                   alpha)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = np.float32(1) - np.float32(count) / np.float32(
                warmup_steps)
            return float(np.float32(init_value - peak_value) * frac
                         + np.float32(peak_value))
        return cosine(count - warmup_steps)
    return schedule


def trainer_schedule(lr: float, steps: int) -> Schedule:
    """The rec and det trainers' schedule: warmup from 0 over
    min(100, steps // 10 + 1) updates, cosine decay to 0 at `steps`."""
    return warmup_cosine_decay_schedule(0.0, lr, min(100, steps // 10 + 1),
                                        steps)


class Local:
    """The batch reductions of an unsharded step, where the whole batch is
    on this process. A sharded step (parallel.mesh) puts a MeshSync with
    the same methods in the optimizer's `sync`; the step functions reduce
    their losses through it, the optimizer its gradients."""

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A batch-wide sum of per-shard sums."""
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The batch mean of per-sample values t (B_local, ...)."""
        return t.mean()

    def reduce_grads(self, grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        return grads

    def sq_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The squared global norm of the gradients."""
        return sum(torch.sum(g * g) for g in grads.values())


class Adam:
    """optax.chain(clip_by_global_norm(clip), adam(schedule)) over a list
    of named tensors (clip=None: adam alone). step() reads each tensor's
    .grad and updates it in place; `sync` reduces the gradients first and
    gives the global norm (Local unless the step is sharded).

    A step has a host half and a device half, so that a captured training
    step (graphs.StepProgram) replays with the values of its own update:
    prepare() computes the update's learning rate and bias corrections on
    the host in float32, copies them into the device tensor `hyper`
    (-lr, 1 - b1^count, 1 - b2^count) and moves the count; apply() is the
    device work, which reads nothing back to the host (the clip is a
    select) and takes every per-step value from `hyper`. step() is both.
    The trainers' step functions call prepare() outside their program and
    apply() inside it."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Schedule,
                 clip: Optional[float] = 5.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = dict(params)
        self.schedule, self.clip = schedule, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.sync = Local()
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        dev = next(iter(self.params.values())).device if self.params \
            else torch.device("cpu")
        self.hyper = torch.zeros(3, dtype=torch.float32, device=dev)

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.count)

    def prepare(self) -> None:
        """The host half of the next update: -lr at the count, the bias
        corrections at count + 1 (np.float32, as optax computes them) into
        `hyper`, then the count moves. Runs once per step, outside any
        captured program."""
        count = self.count + 1
        vals = np.asarray([
            -np.float32(self.schedule(self.count)),
            np.float32(1) - np.float32(self.b1) ** np.float32(count),
            np.float32(1) - np.float32(self.b2) ** np.float32(count)],
            np.float32)
        src = torch.from_numpy(vals)
        if self.hyper.is_cuda:
            # a pinned source is held by the host allocator until the
            # copy has run, so the next step cannot overwrite it early
            self.hyper.copy_(src.pin_memory(), non_blocking=True)
        else:
            self.hyper.copy_(src)
        self.count = count

    @torch.no_grad()
    def apply(self) -> None:
        """The device half: clip, moments, update, all on the device."""
        grads = self.sync.reduce_grads(
            {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in self.params.items()})
        if self.clip is not None:
            norm = torch.sqrt(self.sync.sq_norm(grads))
            keep = norm < self.clip
            grads = {k: torch.where(keep, g, (g / norm) * self.clip)
                     for k, g in grads.items()}
        step_size, bc1, bc2 = self.hyper.unbind()
        for k, p in self.params.items():
            g = grads[k]
            mu = self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
            nu = self.nu[k].mul_(self.b2).add_((1 - self.b2) * (g * g))
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(step_size * upd)

    def step(self) -> None:
        self.prepare()
        self.apply()

    def state(self) -> Dict[str, torch.Tensor]:
        """The tensors a step updates in place, by name: the moments and
        `hyper` (a captured step holds their storage)."""
        out = {"hyper": self.hyper}
        for k in self.params:
            out[f"mu/{k}"] = self.mu[k]
            out[f"nu/{k}"] = self.nu[k]
        return out

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """{"count": (), "mu/<name>": ..., "nu/<name>": ...}."""
        out = {"count": torch.tensor(self.count, dtype=torch.int64)}
        for k in self.params:
            out[f"mu/{k}"] = self.mu[k]
            out[f"nu/{k}"] = self.nu[k]
        return out

    def load_state_dict(self, state: Dict) -> None:
        """Copies the moments into the tensors the optimizer holds (a
        captured step keeps writing them) and sets the count."""
        self.count = int(np.asarray(state["count"]).reshape(-1)[0])
        for k in self.params:
            for name, buf in (("mu", self.mu), ("nu", self.nu)):
                src = torch.as_tensor(np.asarray(state[f"{name}/{k}"]))
                if src.shape != buf[k].shape:
                    raise ValueError(f"{name}/{k}: shape {tuple(src.shape)} "
                                     f"!= {tuple(buf[k].shape)}")
                buf[k].copy_(src)


def halves(opt) -> Tuple[Callable[[], None], Callable[[], None]]:
    """An optimizer's step as (host half, device half): Adam's prepare and
    apply. An optimizer with step() alone runs it whole as the device
    half; it must then read nothing back to the host and keep every
    per-step value in a tensor."""
    if isinstance(opt, Adam):
        return opt.prepare, opt.apply
    return (lambda: None), opt.step


def step_state(model: torch.nn.Module, opt) -> Dict[str, torch.Tensor]:
    """What a training step reads and writes in place besides its batch:
    the model's parameters and buffers (BatchNorm statistics), the
    optimizer's moments and per-step values (graphs.StepProgram.state)."""
    out = {f"model/{k}": t for k, t in model.named_parameters()}
    out.update({f"model/{k}": t for k, t in model.named_buffers()})
    if isinstance(opt, Adam):
        out.update({f"opt/{k}": t for k, t in opt.state().items()})
    return out


def trainable(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters that are flax leaves: all but each LSTM's bias_ih,
    which stays at zero (flax's cell has one bias a gate, carried into
    bias_hh; training both would step that bias twice)."""
    out = {}
    for name, p in model.named_parameters():
        if name.endswith("bias_ih_l0"):
            p.requires_grad_(False)
            continue
        out[name] = p
    return out


def train_device(device: str) -> torch.device:
    """The trainers' device: the card unless the caller asks for the CPU;
    no fallback. On the card TF32 is off, so float32 steps are float32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' to "
                               "train on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
