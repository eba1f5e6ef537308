"""The gather probe's kernels: XOR of table rows picked by indices.

Counterpart of the two kernels of benchmarks/pallas_gather_probe.py:
`gather_xor` (K3, pallas_gather: one accumulator) and
`gather_xor_chains` (K4, pallas_gather_chains: `unroll` independent
accumulators). Both compute

    out[0, :] = XOR over i < NS of table[idx[i], :]

for int32 indices idx (NS,) and a (WT, 8) table of uint32 words held in
an int32 tensor (utils/convert.py), out (1, 8) int32. XOR is associative
and commutative, so every order gives the same bits: the kernels match
the plain version bit for bit. On a CUDA tensor they run in the
hand-written kernel of csrc/gather_probe.cu, one kernel for both on the
card (its head note says why); on a CPU tensor in
`gather_xor_reference`.
"""

from __future__ import annotations

import torch

ROW_WORDS = 8
# The probe's settings: 1, 4, 8 for K3 and 8, 16, 32 for K4.
UNROLLS = (1, 4, 8, 16, 32)


def _check(idx: torch.Tensor, table: torch.Tensor) -> None:
    if idx.dim() != 1 or table.dim() != 2 or table.shape[1] != ROW_WORDS:
        raise ValueError(
            f"want idx (NS,) and table (WT, {ROW_WORDS}), got "
            f"{tuple(idx.shape)} and {tuple(table.shape)}"
        )
    if idx.dtype != torch.int32 or table.dtype != torch.int32:
        raise TypeError(
            f"idx and table must be int32, got {idx.dtype} and {table.dtype}"
        )
    if idx.device != table.device:
        raise ValueError(
            f"operands on different devices: {idx.device}, {table.device}"
        )
    if not (idx.is_contiguous() and table.is_contiguous()):
        raise ValueError("idx and table must be contiguous")
    if table.shape[0] == 0:
        raise ValueError("table has no rows")
    if max(idx.shape[0], table.shape[0]) >= 1 << 31:
        raise ValueError("idx and table must have fewer than 2^31 rows")


def _xor_fold(rows: torch.Tensor) -> torch.Tensor:
    """(N, W) -> (1, W): XOR of all rows, halving N each step (torch has
    no XOR reduction). An odd row out goes into row 0 of the next step."""
    if rows.shape[0] == 0:
        return torch.zeros((1, rows.shape[1]), dtype=rows.dtype,
                           device=rows.device)
    while rows.shape[0] > 1:
        h = rows.shape[0] // 2
        folded = rows[:h] ^ rows[h:2 * h]
        if rows.shape[0] % 2:
            folded[0] ^= rows[-1]
        rows = folded
    return rows.clone()


def gather_xor_reference(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain torch version: `table[idx]`, then a halving XOR fold.
    Indices outside [0, WT) raise IndexError (torch's indexing would
    wrap negative ones)."""
    _check(idx, table)
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= table.shape[0]):
        raise IndexError(f"indices must lie in [0, {table.shape[0]})")
    return _xor_fold(table[idx.long()])


def _launch(entry: str, wrapper, idx: torch.Tensor, table: torch.Tensor,
            unroll: int) -> torch.Tensor:
    _check(idx, table)
    if unroll not in UNROLLS:
        raise ValueError(f"unroll must be one of {UNROLLS}, got {unroll}")
    if idx.device.type == "cpu":
        return gather_xor_reference(idx, table)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (the kernel reads "
                         "rows as 16-byte vectors)")
    from galah_tpu_torch.ops._build import load_library

    ns, wt = idx.shape[0], table.shape[0]
    out = torch.zeros((1, ROW_WORDS), dtype=torch.int32, device=idx.device)
    if ns == 0:
        return out
    lib = load_library()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = getattr(lib, entry)(
            idx.data_ptr(), table.data_ptr(), out.data_ptr(), ns, wt, unroll,
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{entry} launch failed: CUDA error {err} "
            f"(ns={ns}, wt={wt}, unroll={unroll})"
        )
    wrapper.launches += 1
    return out


def gather_xor(idx: torch.Tensor, table: torch.Tensor,
               unroll: int = 1) -> torch.Tensor:
    """(1, 8) int32 XOR of the indexed rows (K3), `unroll` 16-byte row
    loads in flight a thread. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    return _launch("galah_gather_xor", gather_xor, idx, table, unroll)


def gather_xor_chains(idx: torch.Tensor, table: torch.Tensor,
                      unroll: int = 8) -> torch.Tensor:
    """As gather_xor (K4: the same kernel on the card)."""
    return _launch("galah_gather_xor_chains", gather_xor_chains, idx, table,
                   unroll)


gather_xor.launches = 0
gather_xor_chains.launches = 0
