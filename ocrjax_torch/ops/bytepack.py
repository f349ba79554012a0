"""Device-to-host payloads (port of ocrjax/ops/bytepack.py): what a lane
copies off the card and how.

A lane packs its outputs into one row a page or a line, so the host makes
one copy instead of one per tensor. With cfg.fetch_bytes the row is uint8:
token ids, token counts and flags as bytes (small exact integers) and each
float32 column as its four raw bytes, never quantized, so the values read
back are bit for bit the device's. Otherwise the row is float32 (the
reference's legacy layout). The token block comes first in every layout,
so truncate_tokens can cut it to the first T_f columns a line
(cfg.fetch_max_tokens): the columns past a line's n_tokens are CTC
padding, the host refetches the whole row, still on the device, for the
rare chunk with a longer line.

Byte order: `view(torch.uint8)` gives a float32's bytes in memory order,
low byte first on the card and on x86, as XLA's bitcast puts them;
bytes_to_f32 reads them back with numpy on the host.

HostCopy is the copy itself. On the card it is a non-blocking copy into
pinned host memory, ordered by a CUDA event that the host waits on before
it reads, so the copy runs while the host decodes and dispatches the next
chunk. A tensor on the CPU needs no copy. The host's wait on the event
is the stage fetch_wait.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ocrjax_torch.utils.profiling import stage

# full refetches of truncated payloads, by the stage that made them
# ("fused_fetch", "rec_fetch_decode", "det_fetch", "tile_det_fetch"): a
# refetch is the cost of a first fetch that was too short
refetches: collections.Counter = collections.Counter()


def f32_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """Device side: (..., N) float32 -> (..., 4N) uint8, bit-exact."""
    return x.to(torch.float32).contiguous().view(torch.uint8)


def bytes_to_f32(buf: np.ndarray) -> np.ndarray:
    """Host side: (..., 4N) uint8 -> (..., N) float32, the inverse of
    f32_to_bytes; a non-contiguous slice of a fetched row is accepted."""
    return np.ascontiguousarray(buf, dtype=np.uint8).view(np.float32)


def truncate_tokens(payload: torch.Tensor, K: int, T: int, T_f: int
                    ) -> torch.Tensor:
    """The first-fetch slice of cfg.fetch_max_tokens: a packed payload's
    token block cut from T to T_f columns a line. Every layout (fused, K
    lines a page; pooled recognition, K = 1; uint8 or float32) puts its
    (K * T)-wide token block first and reads the other columns
    independently of T. Exact whenever every n_tokens <= T_f; the
    n_tokens column rides in the untouched remainder, so the host sees an
    overflow and refetches the full row."""
    B = payload.shape[0]
    tok = payload[:, :K * T].reshape(B, K, T)[:, :, :T_f]
    return torch.cat([tok.reshape(B, K * T_f), payload[:, K * T:]], dim=1)


def use_byte_fetch(engine) -> bool:
    """Byte packing is exact only while token ids and counts fit a byte:
    ids are < num_classes <= 255 and counts <= rec_max_tokens <= 255.
    Larger configs keep the float32 payloads."""
    cfg = engine.config
    return bool(cfg.fetch_bytes) and engine.charset.num_classes <= 255 \
        and cfg.rec_max_tokens <= 255


class HostCopy:
    """A device tensor's copy to the host, started at construction and read
    by result(). On the card: a non-blocking copy into a pinned buffer
    (kept until it is read) and a CUDA event recorded after it on the
    current stream; result() waits on the event. A CPU tensor is copied
    at construction too (it may be a program's static output, which a
    later replay overwrites). A buffer that could not be pinned raises: the
    copy would be synchronous, and the overlap lost without a sign."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type != "cuda":
            self.buf = t.clone()
            return
        self.buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if not self.buf.is_pinned():
            raise RuntimeError("the host buffer of a device copy is not "
                               "pinned")
        self.buf.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def result(self, wait: str = "fetch_wait") -> np.ndarray:
        """The copy on the host; `wait` names the host step that waits on
        the event."""
        if self.event is not None:
            with stage(wait, device=False):
                self.event.synchronize()
        return self.buf.numpy()


def fetch(t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host now (HostCopy started and read)."""
    return HostCopy(t).result()
