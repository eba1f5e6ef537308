"""The screen tile's epilogue: from intersection counts to the hit buffer.

Counterpart of the JAX package's device program
galah_tpu/ops/prefilter.py::_resident_screen_extract from the counts on
(_containment, the cutoff, the diagonal mask, _extract_above_cutoff).
For one (m, n) tile of counts and the rows' float32 set sizes it gives

- the float32 containment matrix (m, n), in the reference's operation
  order (_containment);
- one int32 hit buffer of 2 + 2 * cap words: [hit count, rows with a
  hit (when `streaming`, else 0), the first cap hits' flat indices
  i * n + j in row-major order, their containment rounded to bfloat16
  as float32 bits], zeros in the slots past the count. A hit is
  containment >= the float32 cutoff, with j > i on a diagonal tile.

On a CUDA tensor it runs in the hand-written kernel
csrc/screen_epilogue.cu (K6, one launch a tile, laid out by
`epilogue_plan`); on a CPU tensor in the plain torch version below.
Both give the same bits.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

# K6's launch plan: rows a block so that a 1024-row tile takes about two
# blocks on each of an H100's 132 SMs (measured against one and four:
# tools/k6_profile.py --target-blocks), and a block at least 1,024
# elements, a 16-byte unit for each of its 256 threads; at most 32 rows,
# the kernel's one word of row flags.
TARGET_BLOCKS = 264
MIN_BLOCK_ELEMENTS = 1024
MAX_ROWS = 32
# int64 words of K6's scratch, allocated at least this large: a word of
# two counters (ticket, done), a status word a block and a 32-bit zeroed
# flag a block (scratch_words).
MIN_SCRATCH_WORDS = 4096


def _containment(
    counts: torch.Tensor, a: torch.Tensor, b: torch.Tensor, bits_f: float
) -> torch.Tensor:
    """Collision-corrected max containment, float32.

    counts: (bi, bj); a: (bi,) sizes; b: (bj,) sizes.
    Two-step correction: E[c_obs] ~= c + (a-c)(b-c)/B."""
    a = a[:, None]
    b = b[None, :]
    c1 = torch.clamp(counts - a * b / bits_f, min=0.0)
    c = torch.clamp(counts - (a - c1) * (b - c1) / bits_f, min=0.0)
    denom = torch.clamp(torch.minimum(a, b), min=1.0)
    return torch.clamp(c / denom, max=1.0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bfloat16, as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _extract_hits(mask: torch.Tensor, cont: torch.Tensor, cap: int,
                  rows: bool) -> torch.Tensor:
    """One tile's hit buffer (module docstring) from its hit mask and
    containment: the hit of slot s is the first position whose inclusive
    prefix count reaches s; slots past the count hold zeros."""
    flat = mask.reshape(-1)
    out = torch.zeros(2 + 2 * cap, dtype=torch.int32, device=mask.device)
    if not flat.numel():
        return out
    csum = torch.cumsum(flat, 0, dtype=torch.int32)
    slots = torch.arange(1, cap + 1, dtype=torch.int32, device=mask.device)
    live = slots <= csum[-1]
    idx = torch.searchsorted(csum, slots, out_int32=True)
    idx = idx.clamp_(max=flat.numel() - 1)
    vals = _bf16(cont.reshape(-1).index_select(0, idx))
    out[0] = csum[-1]
    if rows:
        out[1] = mask.any(dim=1).sum(dtype=torch.int32)
    out[2:2 + cap] = torch.where(live, idx, 0)
    out[2 + cap:] = torch.where(live, vals.view(torch.int32), 0)
    return out


def screen_epilogue_reference(
    counts: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
    bits_f: float, min_cont_f: float, diag: bool, cap: int, streaming: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: (containment, hit buffer) of one tile."""
    cont = _containment(counts.to(torch.float32), a, b, bits_f)
    mask = cont >= min_cont_f
    if diag:
        mask &= torch.ones(mask.shape, dtype=torch.bool,
                           device=mask.device).triu_(1)
    return cont, _extract_hits(mask, cont, cap, rows=streaming)


def epilogue_plan(m: int, n: int) -> Tuple[int, int]:
    """(rows a block, blocks) of K6 on an (m, n) tile: at least one
    block, even when m is 0."""
    rows = max(-(-m // TARGET_BLOCKS), -(-MIN_BLOCK_ELEMENTS // max(n, 1)))
    rows = min(MAX_ROWS, max(1, rows))
    return rows, max(1, -(-m // rows))


# K6's scratch by (device index, stream): launches on one stream never
# overlap, and each leaves the scratch zero for the next. A CUDA graph
# keeps the scratch of the stream it was captured on, so every scratch
# made stays alive (_RETIRED) when a larger one replaces it.
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}
_RETIRED: List[torch.Tensor] = []


def scratch_words(blocks: int) -> int:
    """int64 words K6's scratch needs for a grid of `blocks`."""
    return 1 + blocks + (blocks + 1) // 2


def _scratch(device: torch.device, stream: int, blocks: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < scratch_words(blocks):
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(MIN_SCRATCH_WORDS, scratch_words(blocks)),
                          dtype=torch.int64, device=device)
        _SCRATCH[key] = buf
    return buf


def screen_epilogue(
    counts: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
    bits_f: float, min_cont_f: float, diag: bool, cap: int, streaming: bool,
    shard: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(containment (m, n) float32, hit buffer (2 + 2 cap,) int32) of a
    tile of int32 or float32 counts and float32 sizes a (m,), b (n,). A
    CPU tensor takes the plain version; a CUDA tensor launches K6 on the
    current stream or raises, with no host sync. `shard` is where the
    launch is also counted in `per_shard`, as for K1."""
    _check(counts, a, b, cap)
    if counts.device.type == "cpu":
        return screen_epilogue_reference(
            counts, a, b, bits_f=bits_f, min_cont_f=min_cont_f, diag=diag,
            cap=cap, streaming=streaming)
    if counts.device.type != "cuda":
        raise ValueError(f"unsupported device {counts.device}")
    from galah_tpu_torch.ops._build import load_library

    m, n = counts.shape
    rows, blocks = epilogue_plan(m, n)
    cont = torch.empty((m, n), dtype=torch.float32, device=counts.device)
    hits = torch.empty(2 + 2 * cap, dtype=torch.int32, device=counts.device)
    entry = load_library().galah_screen_epilogue
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream(counts.device).cuda_stream
        scratch = _scratch(counts.device, stream, blocks)
        err = entry(counts.data_ptr(), int(counts.dtype == torch.float32),
                    a.data_ptr(), b.data_ptr(), cont.data_ptr(),
                    hits.data_ptr(), scratch.data_ptr(), m, n, bits_f,
                    min_cont_f, int(diag), cap, int(streaming), rows, stream)
    if err != 0:
        raise RuntimeError(
            f"galah_screen_epilogue launch failed: CUDA error {err} "
            f"(m={m}, n={n}, cap={cap})")
    screen_epilogue.launches += 1
    if shard is not None:
        screen_epilogue.per_shard[shard] += 1
    return cont, hits


screen_epilogue.launches = 0
screen_epilogue.per_shard = Counter()


def _check(counts: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           cap: int) -> None:
    if counts.dim() != 2 or a.dim() != 1 or b.dim() != 1:
        raise ValueError(
            f"want (m, n) counts and (m,), (n,) sizes, got "
            f"{tuple(counts.shape)}, {tuple(a.shape)}, {tuple(b.shape)}")
    m, n = counts.shape
    if a.shape[0] != m or b.shape[0] != n:
        raise ValueError(
            f"sizes {tuple(a.shape)}, {tuple(b.shape)} do not fit counts "
            f"{tuple(counts.shape)}")
    if counts.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"counts must be int32 or float32, got {counts.dtype}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"sizes must be float32, got {a.dtype}, {b.dtype}")
    if not (counts.device == a.device == b.device):
        raise ValueError(f"operands on different devices: {counts.device}, "
                         f"{a.device}, {b.device}")
    if not (counts.is_contiguous() and a.is_contiguous()
            and b.is_contiguous()):
        raise ValueError("counts and sizes must be contiguous")
    if m * n >= 1 << 31 or cap < 0:
        raise ValueError(f"tile {m} x {n} with cap {cap} out of range")
