"""Streaming FASTA reader.

Gzip-transparent and tolerant of tab-containing headers. The reference
sanitizes tabs to spaces before handing files to skani because tabs
would corrupt skani's TSV output (src/skani.rs:80-107); here the raw
header is preserved, and consumers pick the representation they need
(`contig_names` applies the reference's tab-split rule,
src/cluster_argument_parsing.rs:607-611).

Host-side I/O feeding device buffers; the heavy per-base work (k-mer
hashing) happens in galah_tpu_torch.sketch, optionally via the C++ native
extension.

The port's own copy of galah_tpu/io/fasta.py, so that the port imports
nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, List


@dataclass
class FastaRecord:
    name: str      # full header line minus '>' (tabs preserved)
    seq: bytes     # raw sequence bytes, newlines stripped (case preserved)

    @property
    def sanitized_name(self) -> str:
        """Header with tabs replaced by spaces (src/skani.rs:94-96)."""
        return self.name.replace("\t", " ")

    @property
    def contig_name(self) -> str:
        """Header up to the first tab — the reference's contig naming rule
        (src/cluster_argument_parsing.rs:607-611)."""
        return self.name.split("\t")[0]


def _open_binary(path: str):
    # Sniff gzip by magic bytes rather than extension; the reference's
    # needletail is extension-agnostic too (tests/test_cmdline.rs:612-629).
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


def read_fasta(path: str) -> Iterator[FastaRecord]:
    """Stream records from a (possibly gzipped) FASTA file."""
    name = None
    chunks: List[bytes] = []
    with _open_binary(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield FastaRecord(name, b"".join(chunks))
                name = line[1:].decode("utf-8", errors="replace")
                chunks = []
            elif line:
                if name is None:
                    raise ValueError(f"FASTA file {path} does not start with a header line")
                chunks.append(line)
    if name is not None:
        yield FastaRecord(name, b"".join(chunks))


def read_fasta_sequences(path: str) -> List[bytes]:
    """All sequences of a FASTA file as a list of byte strings."""
    return [rec.seq for rec in read_fasta(path)]


def contig_names(path: str) -> List[str]:
    """Contig names (header up to the first tab) in file order."""
    return [rec.contig_name for rec in read_fasta(path)]


def sanitize_header(header: str) -> str:
    """Replace tabs with spaces (reference: src/skani.rs:94-96)."""
    return header.replace("\t", " ")


def decompressed_size_estimate(path: str) -> int:
    """Cheap upper-ish bound on a FASTA file's sequence length without
    reading it: plain files report their size (headers/newlines only
    inflate it — safe direction for sizing bitmaps); gzip files report
    the ISIZE trailer (uncompressed length mod 2^32), floored at
    3x the compressed size.  The floor matters because ISIZE alone
    lies low in two real cases — multi-member files (``cat a.gz b.gz``
    stores only b's length) and >4GiB genomes (mod-2^32 wrap) — and
    under-estimating silently shrinks sketch bitmaps below what the
    genomes need, while over-estimating merely pads them (DNA gzips
    ~3-4x, so 3x compressed is still a lower bound on the truth)."""
    import os

    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        if fh.read(2) == b"\x1f\x8b" and size >= 18:
            fh.seek(-4, 2)
            isize = int.from_bytes(fh.read(4), "little")
            return max(isize, size * 3)
    return size
