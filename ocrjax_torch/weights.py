"""Reads and writes safetensors weights in flax's flat layout, and carries
them between that layout and the port's modules (both ways: the writer is
how ocrjax loads what the port trains).

The reader is plain numpy (the safetensors layout: an 8-byte little-endian
header length, a JSON header of {name: {dtype, shape, data_offsets}} plus
`__metadata__`, then the raw buffers). Keys are the flax variable paths,
e.g. "params/BiLSTM_0/OptimizedLSTMCell_0/hi/kernel".

Layout maps (the port of ocrjax/weights.py's tables):
  conv    flax (kh, kw, I, O)  -> torch (O, I, kh, kw)
  convT   flax (kh, kw, I, O)  -> torch (I, O, kh, kw), spatially flipped
          (lax.conv_transpose does not mirror the kernel the way
          torch's conv_transpose2d does)
  linear  flax (I, O)          -> torch (O, I)
  vec     as it is (biases, norms, SVTR's positional embedding)
  lstm    flax per-gate ii/if/ig/io (input, no bias) + hi/hf/hg/ho (hidden,
          with bias) -> torch packed (4H, .) rows in gate order i, f, g, o;
          the flax bias goes to bias_hh and bias_ih is zero
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
           "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
           "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> Tuple[Dict[str, np.ndarray],
                                         Dict[str, str]]:
    """-> ({flax_path: array}, metadata)."""
    with open(path, "rb") as f:
        header = _read_header(f)
        data = f.read()
    meta = header.pop("__metadata__", None) or {}
    out = {}
    for key, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: unsupported dtype {info['dtype']} "
                             f"for {key}")
        lo, hi = info["data_offsets"]
        out[key] = np.frombuffer(data[lo:hi], dtype=_DTYPES[info["dtype"]]
                                 ).reshape(info["shape"]).copy()
    return out, meta


_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}
SEP = "/"


def _read_header(f) -> dict:
    (n,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(n))


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested {'params': {'Conv_0': {...}}} -> {"params/Conv_0/...": leaf};
    a flat dict comes back as it is."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def save_variables(path: str, variables: Mapping[str, Any],
                   metadata: Mapping[str, Any] = None) -> None:
    """Writes a flax-layout variables tree ({'params': {...},
    'batch_stats': {...}}, nested or already flat with "/" keys) to one
    safetensors file that ocrjax.weights.load_variables reads. Arrays are
    written C-contiguous in their own dtype; metadata values as strings."""
    flat = {}
    for k, v in flatten(variables).items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        # np.array, not np.ascontiguousarray, which makes a scalar 1-d
        flat[k] = np.array(v, order="C")
    header: Dict[str, Any] = {}
    offset = 0
    for key in sorted(flat):
        a = flat[key]
        if a.dtype not in _NAMES:
            raise ValueError(f"unsupported dtype {a.dtype} for {key}")
        header[key] = {"dtype": _NAMES[a.dtype], "shape": list(a.shape),
                       "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)     # data starts 8-byte aligned
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for key in sorted(flat):
            f.write(flat[key].tobytes())


def load_metadata(path: str) -> Dict[str, str]:
    """The file's `__metadata__` (header only)."""
    with open(path, "rb") as f:
        return dict(_read_header(f).get("__metadata__") or {})


def save_charset_sidecar(weights_path: str, charset) -> str:
    """Writes the charset beside the weights as `<stem>.charset.txt`, the
    file from_pretrained reads; returns its path."""
    p = os.path.splitext(weights_path)[0] + ".charset.txt"
    charset.to_file(p)
    return p


def _f2t(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
    if kind == "convT":
        return np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1))
    if kind == "linear":
        return np.ascontiguousarray(a.T)
    return np.ascontiguousarray(a)


def _t2f(a: np.ndarray, kind: str) -> np.ndarray:
    """The inverse of _f2t."""
    if kind == "conv":
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    if kind == "convT":
        return np.ascontiguousarray(a.transpose(2, 3, 0, 1)[::-1, ::-1])
    if kind == "linear":
        return np.ascontiguousarray(a.T)
    return np.ascontiguousarray(a)


Table = List[Tuple[str, str, str]]  # (flax path, torch key, layout kind)


def _bn_entries(flax_mod: str, torch_mod: str) -> Table:
    return [
        (f"params/{flax_mod}/scale", f"{torch_mod}.weight", "vec"),
        (f"params/{flax_mod}/bias", f"{torch_mod}.bias", "vec"),
        (f"batch_stats/{flax_mod}/mean", f"{torch_mod}.running_mean", "vec"),
        (f"batch_stats/{flax_mod}/var", f"{torch_mod}.running_var", "vec"),
    ]


def _cbr_entries(flax_mod: str, torch_mod: str, bn: bool) -> Table:
    """flax ConvBNRelu_k -> torch ConvBNRelu (.conv, .bn)."""
    t = [(f"params/{flax_mod}/Conv_0/kernel", f"{torch_mod}.conv.weight",
          "conv")]
    if bn:
        t += _bn_entries(f"{flax_mod}/BatchNorm_0", f"{torch_mod}.bn")
    else:
        t.append((f"params/{flax_mod}/Conv_0/bias", f"{torch_mod}.conv.bias",
                  "vec"))
    return t


def _crnn_key_table() -> Table:
    t: Table = []
    for i in range(7):
        t += _cbr_entries(f"ConvBNRelu_{i}", f"conv{i}", bn=i in (2, 4, 6))
    t.append(("params/Dense_0/kernel", "fc.weight", "linear"))
    t.append(("params/Dense_0/bias", "fc.bias", "vec"))
    return t


_GATES = ("i", "f", "g", "o")


def _lstm_f2t(sd: Dict[str, np.ndarray], flat: Mapping, flax_cell: str,
              prefix: str) -> List[str]:
    """One flax OptimizedLSTMCell -> one torch nn.LSTM (`prefix`). Returns
    the flax keys it read."""
    used = [f"{flax_cell}/{p}{g}/kernel" for p in "ih" for g in _GATES] \
        + [f"{flax_cell}/h{g}/bias" for g in _GATES]
    wi = np.concatenate([flat[f"{flax_cell}/i{g}/kernel"].T for g in _GATES])
    wh = np.concatenate([flat[f"{flax_cell}/h{g}/kernel"].T for g in _GATES])
    bh = np.concatenate([flat[f"{flax_cell}/h{g}/bias"] for g in _GATES])
    sd[f"{prefix}.weight_ih_l0"] = np.ascontiguousarray(wi)
    sd[f"{prefix}.weight_hh_l0"] = np.ascontiguousarray(wh)
    sd[f"{prefix}.bias_ih_l0"] = np.zeros_like(bh)
    sd[f"{prefix}.bias_hh_l0"] = np.ascontiguousarray(bh)
    return used


def _head_entries(fh: str, th: str, stride: int) -> Table:
    t = _cbr_entries(f"{fh}/ConvBNRelu_0", f"{th}.conv0", bn=True)
    if stride in (1, 2):
        t.append((f"params/{fh}/ConvTranspose_0/kernel", f"{th}.up1.weight",
                  "convT"))
        t.append((f"params/{fh}/ConvTranspose_0/bias", f"{th}.up1.bias",
                  "vec"))
        t += _bn_entries(f"{fh}/BatchNorm_0", f"{th}.bn1")
    if stride == 1:
        t.append((f"params/{fh}/ConvTranspose_1/kernel", f"{th}.up2.weight",
                  "convT"))
        t.append((f"params/{fh}/ConvTranspose_1/bias", f"{th}.up2.bias",
                  "vec"))
    else:
        t.append((f"params/{fh}/Conv_0/kernel", f"{th}.out.weight", "conv"))
        t.append((f"params/{fh}/Conv_0/bias", f"{th}.out.bias", "vec"))
    return t


def _db_key_table(channels=(64, 128, 256, 512), blocks_per_stage=2,
                  head_stride=1) -> Table:
    t: Table = []
    for k in range(2):
        t += _cbr_entries(f"Backbone_0/ConvBNRelu_{k}", f"backbone.stem{k}",
                          bn=True)
    k = 0
    cin = channels[0]
    for i, ch in enumerate(channels):
        for j in range(blocks_per_stage):
            fl = f"Backbone_0/ResBlock_{k}"
            tp = f"backbone.stages.{i}.{j}"
            stride_one = (i == 0) or (j > 0)
            t += _cbr_entries(f"{fl}/ConvBNRelu_0", f"{tp}.conv1", bn=True)
            t.append((f"params/{fl}/Conv_0/kernel", f"{tp}.conv2.weight",
                      "conv"))
            t += _bn_entries(f"{fl}/BatchNorm_0", f"{tp}.bn2")
            if cin != ch or not stride_one:
                t.append((f"params/{fl}/Conv_1/kernel",
                          f"{tp}.conv_p.weight", "conv"))
                t += _bn_entries(f"{fl}/BatchNorm_1", f"{tp}.bn_p")
            cin = ch
            k += 1
    n = len(channels)
    for i in range(n):
        t.append((f"params/FPN_0/Conv_{i}/kernel",
                  f"fpn.lateral.{i}.weight", "conv"))
        t.append((f"params/FPN_0/Conv_{n + i}/kernel",
                  f"fpn.smooth.{i}.weight", "conv"))
    # prob head DBHead_0; threshold head DBHead_1 (train-only, carried)
    t += _head_entries("DBHead_0", "head", head_stride)
    t += _head_entries("DBHead_1", "thresh_head", head_stride)
    return t


def _ln_entries(flax_mod: str, torch_mod: str) -> Table:
    return [(f"params/{flax_mod}/scale", f"{torch_mod}.weight", "vec"),
            (f"params/{flax_mod}/bias", f"{torch_mod}.bias", "vec")]


def _dense_entries(flax_mod: str, torch_mod: str, bias: bool = True
                   ) -> Table:
    t = [(f"params/{flax_mod}/kernel", f"{torch_mod}.weight", "linear")]
    if bias:
        t.append((f"params/{flax_mod}/bias", f"{torch_mod}.bias", "vec"))
    return t


def _svtr_key_table(n_blocks: int) -> Table:
    """models.svtr.SVTR of n_blocks blocks; the flat names are those the
    benchmark's reference/rec_svtr.py draws and reads."""
    t: Table = []
    for i in range(2):
        t.append((f"params/PatchEmbed_0/Conv_{i}/kernel", f"embed{i}.weight",
                  "conv"))
        t += _bn_entries(f"PatchEmbed_0/BatchNorm_{i}", f"bn{i}")
    t.append(("params/pos_embed", "pos_embed", "vec"))
    for k in range(n_blocks):
        fl, tm = f"Block_{k}", f"blocks.{k}"
        for sub, name in (("Attention_0/qkv", "qkv"),
                          ("Attention_0/proj", "proj"),
                          ("Mlp_0/Dense_0", "fc1"), ("Mlp_0/Dense_1", "fc2")):
            t += _dense_entries(f"{fl}/{sub}", f"{tm}.{name}")
        for i in range(2):
            t += _ln_entries(f"{fl}/LayerNorm_{i}", f"{tm}.norm{i + 1}")
    for j in range(2):
        t.append((f"params/SubSample_{j}/Conv_0/kernel",
                  f"merges.{j}.conv.weight", "conv"))
        t.append((f"params/SubSample_{j}/Conv_0/bias",
                  f"merges.{j}.conv.bias", "vec"))
        t += _ln_entries(f"SubSample_{j}/LayerNorm_0", f"merges.{j}.norm")
    t += _dense_entries("Dense_0", "combine", bias=False)
    t += _dense_entries("Dense_1", "fc")
    return t


def _svtr_blocks(flat: Mapping) -> int:
    return len({k.split("/")[1] for k in flat
                if k.startswith("params/Block_")})


def _cls_key_table(n_convs: int = 3) -> Table:
    t: Table = []
    for i in range(n_convs):
        t.append((f"params/Conv_{i}/kernel", f"convs.{i}.weight", "conv"))
        t.append((f"params/Conv_{i}/bias", f"convs.{i}.bias", "vec"))
    for i in range(2):
        t.append((f"params/Dense_{i}/kernel", f"fc{i + 1}.weight", "linear"))
        t.append((f"params/Dense_{i}/bias", f"fc{i + 1}.bias", "vec"))
    return t


def _from_table(flat: Mapping, table: Table) -> Tuple[Dict, List[str]]:
    sd = {tk: _f2t(np.asarray(flat[fk]), kind) for fk, tk, kind in table}
    return sd, [fk for fk, _, _ in table]


def _lstm_t2f(flat: Dict[str, np.ndarray], sd: Mapping, flax_cell: str,
              prefix: str) -> None:
    """One torch nn.LSTM -> one flax OptimizedLSTMCell; the flax bias is
    bias_ih + bias_hh (bias_ih stays zero when carried from flax)."""
    H = sd[f"{prefix}.weight_hh_l0"].shape[1]
    b = sd[f"{prefix}.bias_ih_l0"] + sd[f"{prefix}.bias_hh_l0"]
    for k, g in enumerate(_GATES):
        rows = slice(k * H, (k + 1) * H)
        flat[f"{flax_cell}/i{g}/kernel"] = np.ascontiguousarray(
            sd[f"{prefix}.weight_ih_l0"][rows].T)
        flat[f"{flax_cell}/h{g}/kernel"] = np.ascontiguousarray(
            sd[f"{prefix}.weight_hh_l0"][rows].T)
        flat[f"{flax_cell}/h{g}/bias"] = np.ascontiguousarray(b[rows])


def _np_sd(sd: Mapping) -> Dict[str, np.ndarray]:
    """Copies (a CPU tensor's .numpy() would share its memory, and the
    variables would follow later training)."""
    return {k: (v.detach().float().cpu().numpy().copy()
                if isinstance(v, torch.Tensor) else np.array(v))
            for k, v in sd.items()}


def _to_table(sd: Mapping, table: Table) -> Dict[str, np.ndarray]:
    return {fk: _t2f(sd[tk], kind) for fk, tk, kind in table}


def crnn_variables(sd: Mapping) -> Dict[str, np.ndarray]:
    """models.crnn.CRNN state dict -> flat flax variables (the inverse of
    crnn_state_dict)."""
    sd = _np_sd(sd)
    flat = _to_table(sd, _crnn_key_table())
    for bl, pfx in [("BiLSTM_0", "lstm0"), ("BiLSTM_1", "lstm1")]:
        for cell, d in [("OptimizedLSTMCell_0", "fwd"),
                        ("OptimizedLSTMCell_1", "bwd")]:
            _lstm_t2f(flat, sd, f"params/{bl}/{cell}", f"{pfx}.{d}")
    return flat


def svtr_variables(sd: Mapping) -> Dict[str, np.ndarray]:
    """models.svtr.SVTR state dict -> flat flax-style variables (the
    inverse of svtr_state_dict)."""
    n = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    return _to_table(_np_sd(sd), _svtr_key_table(n))


def db_variables(sd: Mapping, arch: Mapping) -> Dict[str, np.ndarray]:
    """models.db.DBDetector state dict -> flat flax variables (the inverse
    of db_state_dict)."""
    return _to_table(_np_sd(sd), _db_key_table(
        tuple(arch["channels"]), int(arch["blocks_per_stage"]),
        int(arch["head_stride"])))


def cls_variables(sd: Mapping) -> Dict[str, np.ndarray]:
    """models.cls.OrientationClassifier state dict -> flat flax variables
    (the inverse of cls_state_dict)."""
    return _to_table(_np_sd(sd), _cls_key_table())


def crnn_state_dict(flat: Mapping) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """flax CRNN variables -> (models.crnn.CRNN state dict, flax keys read)."""
    sd, used = _from_table(flat, _crnn_key_table())
    for bl, pfx in [("BiLSTM_0", "lstm0"), ("BiLSTM_1", "lstm1")]:
        for cell, d in [("OptimizedLSTMCell_0", "fwd"),
                        ("OptimizedLSTMCell_1", "bwd")]:
            used += _lstm_f2t(sd, flat, f"params/{bl}/{cell}", f"{pfx}.{d}")
    return sd, used


def svtr_state_dict(flat: Mapping) -> Tuple[Dict[str, np.ndarray],
                                             List[str]]:
    """Flat SVTR variables -> (models.svtr.SVTR state dict, keys read)."""
    return _from_table(flat, _svtr_key_table(_svtr_blocks(flat)))


def rec_state_dict(flat: Mapping, arch: str
                   ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """The recognizer named by `arch` (OcrConfig.rec_arch): its state
    dict from flat variables, and the keys read."""
    if arch == "svtr":
        return svtr_state_dict(flat)
    if arch == "crnn":
        return crnn_state_dict(flat)
    raise ValueError(f"unknown rec_arch {arch!r}: 'crnn' or 'svtr'")


def db_state_dict(flat: Mapping, arch: Mapping
                  ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """flax DB variables -> (models.db.DBDetector state dict, keys read).
    arch: channels / blocks_per_stage / head_stride of the detector."""
    return _from_table(flat, _db_key_table(
        tuple(arch["channels"]), int(arch["blocks_per_stage"]),
        int(arch["head_stride"])))


def cls_state_dict(flat: Mapping) -> Tuple[Dict[str, np.ndarray], List[str]]:
    return _from_table(flat, _cls_key_table())


def conv_bn_from_flax(flat: Mapping, module: str, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One flax ConvBNRelu subtree (`module`/Conv_0 kernel HWIO, no bias,
    and `module`/BatchNorm_0 scale, bias, mean, var) -> the (w, scale, bias)
    float32 tensors ops.conv_fused.conv3x3_bn_relu takes, the BatchNorm
    folded by fuse_bn. E.g. module="Backbone_0/ResBlock_0/ConvBNRelu_0"."""
    from ocrjax_torch.ops.conv_fused import fuse_bn
    bn = f"{module}/BatchNorm_0"
    scale, bias = fuse_bn(
        *(np.asarray(flat[k], np.float32) for k in (
            f"params/{bn}/scale", f"params/{bn}/bias",
            f"batch_stats/{bn}/mean", f"batch_stats/{bn}/var")), eps=eps)
    w = np.asarray(flat[f"params/{module}/Conv_0/kernel"], np.float32)
    return (torch.from_numpy(np.ascontiguousarray(w)),
            torch.from_numpy(scale.astype(np.float32)),
            torch.from_numpy(bias.astype(np.float32)))


def model_variables(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """A CRNN, SVTR, DBDetector or OrientationClassifier -> its flat flax
    variables (params and batch_stats), for save_variables."""
    from ocrjax_torch.models.cls import OrientationClassifier
    from ocrjax_torch.models.crnn import CRNN
    from ocrjax_torch.models.db import DBDetector
    from ocrjax_torch.models.svtr import SVTR
    sd = model.state_dict()
    if isinstance(model, CRNN):
        return crnn_variables(sd)
    if isinstance(model, SVTR):
        return svtr_variables(sd)
    if isinstance(model, DBDetector):
        return db_variables(sd, model.arch)
    if isinstance(model, OrientationClassifier):
        return cls_variables(sd)
    raise TypeError(f"no flax layout for {type(model).__name__}")


def load_model_variables(model: torch.nn.Module, flat: Mapping) -> None:
    """Flat flax variables -> the model's parameters and BN statistics
    (strict, as load_into)."""
    from ocrjax_torch.models.cls import OrientationClassifier
    from ocrjax_torch.models.crnn import CRNN
    from ocrjax_torch.models.db import DBDetector
    from ocrjax_torch.models.svtr import SVTR
    if isinstance(model, CRNN):
        sd = crnn_state_dict(flat)[0]
    elif isinstance(model, SVTR):
        sd = svtr_state_dict(flat)[0]
    elif isinstance(model, DBDetector):
        sd = db_state_dict(flat, model.arch)[0]
    elif isinstance(model, OrientationClassifier):
        sd = cls_state_dict(flat)[0]
    else:
        raise TypeError(f"no flax layout for {type(model).__name__}")
    device = next(model.parameters()).device
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(torch.from_numpy(np.array(sd[k])).to(device))
    if set(sd) != set(model.state_dict()):
        raise KeyError("flax variables do not cover the model exactly")


def load_into(module: torch.nn.Module, sd: Mapping[str, np.ndarray]) -> None:
    """Strict load: every module key present, no key left over."""
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
        strict=True)


def init_random_(module: torch.nn.Module, seed: int) -> None:
    """Deterministic random weights from a torch.Generator: normal weights
    scaled by fan-in, zero biases, identity BatchNorm."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("running_var",) or (p.dim() == 1
                                            and leaf == "weight"):
                p.fill_(1.0)
            elif p.dim() <= 1:
                p.zero_()
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
