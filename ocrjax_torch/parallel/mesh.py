"""(dp, tp) parallelism on torch.distributed (port of
ocrjax/parallel/mesh.py).

One process per device (SPMD): every rank runs the same program on the
same host inputs, and a `DeviceMesh` with dims ("dp", "tp") over the
process group says which slice of the work is its own. NCCL on the card,
gloo on the CPU; the caller initializes the process group
(torch.distributed.init_process_group with an address, world size and
rank). The reference lets GSPMD insert the collectives; here they are
explicit, where GSPMD puts them:

  * data parallelism: rank r of a dp group of size dp holds rows
    r*B/dp : (r+1)*B/dp of a batch (shard_batch), as NamedSharding(P("dp"))
    lays them out. A training step's losses and train-mode BatchNorm
    statistics are sums over the whole batch, all-reduced with autograd
    flowing through them (MeshSync); every rank thus backpropagates the
    same global loss, so the summed gradients are divided by dp, and every
    rank takes the same optimizer step. Serving functions return the whole
    batch's result on every rank (an all-gather), as a global jax.Array
    holds it;
  * tensor parallelism (the CRNN): every parameter is column-parallel on
    its output axis (param_placements, the counterpart of _param_spec): a
    conv's output channels, the projection's classes, each LSTM gate's
    hidden rows, and the per-channel vectors with them. An axis that does
    not divide tp stays replicated. The activations are all-gathered
    before the next contraction (TpGroup.gather, whose gradient is the
    rank's slice), and a replicated input entering a sharded contraction
    sums its partial gradients over tp (TpGroup.copy), as Megatron's
    column-parallel layers do. The LSTM then runs a frame loop
    (models.crnn.lstm_column_parallel) in place of cuDNN's. The detector
    and the orientation classifier replicate over tp.

The card machine has one GPU, so there the sharded paths run at world size
1 over NCCL; multi-rank results are held on the CPU with gloo.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

DP_AXIS = "dp"
TP_AXIS = "tp"


def make_mesh(n_dp: Optional[int] = None, n_tp: int = 1) -> DeviceMesh:
    """(dp, tp) mesh over the initialized process group's ranks; a rank's
    tp peers are consecutive ranks. On NCCL each rank's device is
    cuda:(rank % device count)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed."
                           "init_process_group first")
    n = dist.get_world_size()
    if n_dp is None:
        n_dp = n // n_tp
    if n_dp * n_tp != n:
        raise ValueError(f"{n_dp}x{n_tp} mesh != {n} devices")
    if dist.get_backend() == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        device_type = "cuda"
    else:
        device_type = "cpu"
    return init_device_mesh(device_type, (n_dp, n_tp),
                            mesh_dim_names=(DP_AXIS, TP_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def batch_sharding(mesh: DeviceMesh) -> list:
    """Leading axis sharded over dp, replicated over tp."""
    return [Shard(0), Replicate()]


def replicated(mesh: DeviceMesh) -> list:
    return [Replicate(), Replicate()]


def dp_slice(mesh: DeviceMesh, n: int) -> slice:
    """This rank's rows of an n-row batch; n must divide the dp size."""
    dp = mesh.size(0)
    if n % dp:
        raise ValueError(f"batch of {n} is not a multiple of the dp axis "
                         f"size {dp}")
    r = mesh.get_local_rank(DP_AXIS)
    return slice(r * n // dp, (r + 1) * n // dp)


def shard_batch(mesh: DeviceMesh, tree: Any) -> Any:
    """Every array of a (nested) tuple, list or dict, or one array -> this
    rank's dp slice of its leading axis, as a tensor on the mesh's
    device."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(mesh, x) for x in tree)
    t = tree if torch.is_tensor(tree) else torch.as_tensor(np.asarray(tree))
    return t[dp_slice(mesh, t.shape[0])].contiguous().to(mesh_device(mesh))


def gather_rows(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """The dp group's slices of a batch, concatenated in rank order (every
    slice has t's shape): the whole batch on every rank."""
    group = mesh.get_group(DP_AXIS)
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(0))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.bool() if t.dtype == torch.bool else out


# ---------------------------------------------------------------------------
# Collectives with their gradients
# ---------------------------------------------------------------------------

class _CopyToTp(torch.autograd.Function):
    """Identity; the gradient is summed over tp (a replicated input whose
    consumers are sharded over tp)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherTp(torch.autograd.Function):
    """All-gather along `dim` over tp; the gradient is this rank's slice
    (the consumers are replicated over tp)."""

    @staticmethod
    def forward(ctx, x, group, dim, rank, size):
        ctx.dim, ctx.rank, ctx.size = dim, rank, size
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, dim=ctx.dim)[ctx.rank].contiguous(), \
            None, None, None, None


@dataclasses.dataclass
class TpGroup:
    """A tp group as the CRNN's sharded layers use it (their `tp`)."""
    group: Any
    rank: int
    size: int

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToTp.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherTp.apply(x, self.group, dim, self.rank, self.size)


class MeshSync:
    """train.optim.Local's reductions over the dp axis of a mesh: the step
    functions' loss sums and means, BatchNorm's moments (its `sync`), the
    optimizer's gradients and their global norm (with tp shards)."""

    def __init__(self, mesh: DeviceMesh, sharded=frozenset()):
        self.dp_group = mesh.get_group(DP_AXIS)
        self.tp_group = mesh.get_group(TP_AXIS)
        self.dp = mesh.size(0)
        self.sharded = frozenset(sharded)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """Summed over dp; the gradient of each rank's t is the sum of
        the ranks' output gradients."""
        return dist_nn.all_reduce(t, group=self.dp_group)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        return self.sum(t.sum()) / float(t.numel() * self.dp)

    def reduce_grads(self, grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Summed over dp in one collective, divided by dp: every rank
        backpropagated the same global loss."""
        names = list(grads)
        flat = torch.cat([grads[k].reshape(-1) for k in names])
        dist.all_reduce(flat, group=self.dp_group)
        flat /= self.dp
        out, off = {}, 0
        for k in names:
            n = grads[k].numel()
            out[k] = flat[off:off + n].view(grads[k].shape)
            off += n
        return out

    def sq_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        rep = sum(torch.sum(g * g) for k, g in grads.items()
                  if k not in self.sharded)
        sh = sum((torch.sum(g * g) for k, g in grads.items()
                  if k in self.sharded),
                 torch.zeros((), device=next(iter(grads.values())).device))
        sh = sh.reshape(1)
        dist.all_reduce(sh, group=self.tp_group)
        return rep + sh[0]


# ---------------------------------------------------------------------------
# Tensor-parallel placements
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Split:
    """Column-parallel over tp: axis 0 (the output axis in PyTorch's
    layout) is cut into `blocks` equal blocks, and each block is split
    evenly over the tp ranks; a rank holds its slice of every block. The
    LSTM's (4H, ...) tensors have 4 blocks, the gates i, f, g, o, so a rank
    holds H/tp rows of each gate, as flax's one kernel a gate sharded on
    its hidden axis. (A plain Shard(0) would give rank 0 gates i and f
    whole.)"""
    blocks: int = 1

    def local(self, t: torch.Tensor, rank: int, n: int) -> torch.Tensor:
        v = t.reshape(self.blocks, -1, *t.shape[1:])
        k = v.shape[1] // n
        return v[:, rank * k:(rank + 1) * k].reshape(-1, *t.shape[1:])

    def full(self, parts) -> torch.Tensor:
        """The tensor from every rank's local slice, in rank order."""
        shape = parts[0].shape
        v = [p.reshape(self.blocks, -1, *shape[1:]) for p in parts]
        return torch.cat(v, dim=1).reshape(-1, *shape[1:])


def param_placements(model: torch.nn.Module, n_tp: int
                     ) -> Dict[str, Optional[Split]]:
    """Every parameter and buffer name of a CRNN -> its Split, or None
    (replicated) where the split axis does not divide n_tp; the
    counterpart of ocrjax's _param_spec. Other models replicate over tp:
    their placements are all None."""
    from ocrjax_torch.models.crnn import CRNN
    out = {}
    for name, t in _tensors(model).items():
        blocks = 4 if name.startswith(("lstm0.", "lstm1.")) else 1
        ok = (isinstance(model, CRNN) and n_tp > 1
              and (t.shape[0] // blocks) % n_tp == 0)
        out[name] = Split(blocks) if ok else None
    return out


def _tensors(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return dict(list(model.named_parameters()) + list(model.named_buffers()))


def _keep_local(model: torch.nn.Module, opt, rank: int, n_tp: int) -> None:
    """Each split tensor of the model, and the optimizer's moments of it,
    -> this rank's local slice (model.placements), in new storage: before
    the first training step (shard_params)."""
    tensors = _tensors(model)
    for name, p in getattr(model, "placements", {}).items():
        if p is None:
            continue
        tensors[name].data = p.local(tensors[name].data, rank, n_tp).clone()
        if opt is not None and name in opt.mu:
            for buf in (opt.mu, opt.nu):
                buf[name] = p.local(buf[name], rank, n_tp).clone()


def shard_params(mesh: DeviceMesh, model: torch.nn.Module, opt=None
                 ) -> None:
    """Applies param_placements in place: each split tensor keeps this
    rank's local slice (as do the optimizer's moments of it), the layers
    that own split tensors get their TpGroup (conv, BiLSTM, projection),
    and the placements are recorded as model.placements."""
    n_tp = mesh.size(1)
    rank = mesh.get_local_rank(TP_AXIS)
    places = model.placements = param_placements(model, n_tp)
    _keep_local(model, opt, rank, n_tp)
    tp = TpGroup(mesh.get_group(TP_AXIS), rank, n_tp)
    from ocrjax_torch.models.crnn import CRNN, BiLSTM, ConvBNRelu
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, ConvBNRelu) and places[f"{pre}conv.weight"]:
            mod.conv.tp = tp
        elif isinstance(mod, BiLSTM) and places[f"{pre}fwd.weight_ih_l0"]:
            mod.tp = tp
        elif isinstance(mod, CRNN) and places["fc.weight"]:
            mod.tp = tp


@contextlib.contextmanager
def unsharded(mesh: DeviceMesh, model: torch.nn.Module, opt=None):
    """Within the block the model's (and the optimizer's) split tensors
    hold their full values, gathered over tp. On exit each takes its local
    slice of them again, copied into the storage it held before the
    block, so a captured training step (graphs.StepProgram) goes on
    updating the tensors the model holds. For writing variables and
    checkpoints of a sharded model."""
    group, n_tp = mesh.get_group(TP_AXIS), mesh.size(1)
    rank = mesh.get_local_rank(TP_AXIS)
    tensors = _tensors(model)

    def gather(t, split):
        parts = [torch.empty_like(t) for _ in range(n_tp)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return split.full(parts)
    held = []       # (parameter or moment dict, moment name, local, split)
    for name, p in getattr(model, "placements", {}).items():
        if p is None:
            continue
        t = tensors[name]
        held.append((t, None, t.data, p))
        t.data = gather(t.data, p)
        if opt is not None and name in opt.mu:
            for buf in (opt.mu, opt.nu):
                held.append((buf, name, buf[name], p))
                buf[name] = gather(buf[name], p)
    try:
        yield model
    finally:
        with torch.no_grad():
            for holder, key, local, p in held:
                full = holder.data if key is None else holder[key]
                local.copy_(p.local(full, rank, n_tp))
                if key is None:
                    holder.data = local
                else:
                    holder[key] = local


def attach(mesh: DeviceMesh, model: torch.nn.Module, opt) -> None:
    """Puts one MeshSync in the optimizer (gradients, loss reductions) and
    in every BatchNorm of the model (global train-mode statistics)."""
    from ocrjax_torch.models.crnn import BatchNorm
    places = getattr(model, "placements", {})
    sync = MeshSync(mesh, {k for k, p in places.items() if p is not None})
    opt.sync = sync
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.sync = sync


# ---------------------------------------------------------------------------
# Sharded recognition training step
# ---------------------------------------------------------------------------

def make_sharded_rec_train_step(model, tx, mesh: DeviceMesh):
    """THE production rec step (train.rec_trainer.make_train_step, not a
    copy) with the mesh's collectives: the batch is this rank's
    shard_batch slice, the parameters as shard_params left them."""
    from ocrjax_torch.train.rec_trainer import make_train_step
    attach(mesh, model, tx)
    return make_train_step(model, tx)


def init_sharded_rec_state(config, charset, mesh: DeviceMesh,
                           width: int = 64, lr: float = 1e-3,
                           seed: int = 0):
    """A CRNN from `seed` (weights.init_random_, the same on every rank)
    with its parameters laid out on the mesh, and an Adam(lr) over its
    local shards (no clip or schedule, as the reference's optax.adam(lr)).
    -> (model, tx); `width` is the reference's init width, unused here."""
    from ocrjax_torch import weights as W
    from ocrjax_torch.models.crnn import create_crnn
    from ocrjax_torch.train.optim import Adam, trainable
    del width
    model = create_crnn(config, charset.num_classes)
    W.init_random_(model, seed)
    model.to(mesh_device(mesh))
    shard_params(mesh, model)
    return model, Adam(trainable(model), lambda _c: lr, clip=None)


# ---------------------------------------------------------------------------
# Sharded serving
# ---------------------------------------------------------------------------

def make_sharded_fused_ocr_fn(engine, mesh: DeviceMesh,
                              lines_per_page: int = 32,
                              bucket_width: int = 320, beam: bool = False):
    """The engine's fused page program (fused._fused_for, from its
    program registry) over the mesh: every rank
    passes the whole batch, runs its dp slice of the pages with the
    engine's (replicated) models, and gets every page's packed row back by
    one all-gather. fn(gray_up (B, S, S/2) packed or (B, S, S) luma, thr,
    valid_wh (B, 2)) -> FusedOcr's payload for all B pages (uint8 under
    cfg.fetch_bytes, float32 otherwise; fused.unpack_fused reads either).
    B must be a multiple of the dp size."""
    from ocrjax_torch import fused as F
    dev = engine.device

    def fn(gray_up, thr, valid_wh):
        prog = F._fused_for(engine, lines_per_page, bucket_width, beam)
        gray_up, valid_wh = (torch.as_tensor(a) for a in (gray_up, valid_wh))
        s = dp_slice(mesh, gray_up.shape[0])
        return gather_rows(mesh, prog(gray_up[s].to(dev), thr,
                                      valid_wh[s].to(dev)))
    return fn


def shard_tiled_serving(engine, mesh: Optional[DeviceMesh]) -> None:
    """Enables (or, with None, disables) dp-sharded tiled serving on an
    engine: every tile-detection dispatch of ocr_tiled / ocr_tiled_batch /
    detect_tiled pads its tile stack to a dp multiple with white tiles,
    runs its dp slice of the tiles and all-gathers the candidates
    (tiling._dispatch_group); the seam merge and the pooled recognition
    are unchanged. The engine's tile program, made over the mesh, is
    made anew (tiling._tile_forward)."""
    engine.tile_mesh = mesh


# ---------------------------------------------------------------------------
# Trainers on a mesh
# ---------------------------------------------------------------------------

def prepare_training(mesh: DeviceMesh, model: torch.nn.Module, opt) -> None:
    """shard_params, then attach: the trainers' mesh= setup, after any
    resume (checkpoints hold full tensors)."""
    shard_params(mesh, model, opt)
    attach(mesh, model, opt)


def model_variables(mesh: DeviceMesh, model: torch.nn.Module):
    """weights.model_variables of a model on a mesh: the full tensors."""
    from ocrjax_torch import weights as W
    with unsharded(mesh, model):
        return W.model_variables(model)


def save_train_state(mesh: DeviceMesh, path: str, step: int,
                     model: torch.nn.Module, opt) -> None:
    """checkpoint.save_train_state of a model on a mesh: full tensors,
    written by global rank 0 while the others wait."""
    from ocrjax_torch.train import checkpoint as C
    with unsharded(mesh, model, opt):
        if dist.get_rank() == 0:
            C.save_train_state(path, step, model, opt)
    dist.barrier()


def rank0_log(log):
    """`log` on global rank 0, a no-op elsewhere."""
    return log if dist.get_rank() == 0 else (lambda _msg: None)
